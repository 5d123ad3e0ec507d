"""``client_compress`` and ``server_aggregate`` of the port against the
live JAX functions, for the ported presets, both selectors and
``use_kernels`` off and on: 3 rounds × 2 clients, gradients made with
numpy and handed to both.

Each round both packages start from the JAX state (teacher forcing), so a
difference shows in the round that makes it. The port's state, gradients,
payloads and broadcast are flat stacks (``repro_torch.utils.flat``): the
JAX trees go in through the layout's ``flatten`` and come back leaf by
leaf through its ``unflatten``.

* Non-GMF presets (``none``, ``dgc``, ``gmc``, ``dgcwgm``) are elementwise
  float32 maths: payload, U, V, M, nnz, broadcast and download nnz are
  bitwise equal with ``use_kernels=False``. With ``use_kernels=True`` the
  JAX package runs its Pallas kernels in the jitted interpreter, where XLA
  fuses U ← αU + g into a multiply-add, so values are held at rtol 1e-5 /
  atol 1e-6 (tests/test_kernels.py:16); masks and nnz stay exact.
* GMF (``dgcwgmf``): the per-client norms are sums taken in another order,
  so scores differ by a few ulps. nnz is exact; a mask may differ only at
  an element whose score lies within 1e-5 (relative) of its threshold;
  everything else is held at rtol 1e-5 / atol 1e-6. Fused is compared with
  fused (``use_kernels=True``) and staged with staged.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import schemes as js
from repro_torch.core import schemes as ts
from repro_torch.core import sparsify as tsp
from repro_torch.core import stages as tstages
from repro_torch.utils.flat import FlatLayout

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"b": (33,), "conv": (3, 3, 4, 8), "w": (16, 33)}
K = 2
LAYOUT = FlatLayout.of({k: torch.zeros(s) for k, s in SHAPES.items()})
CASES = [("none", {}), ("dgc", {}), ("gmc", {}), ("dgcwgm", {}),
         ("dgcwgmf", {"tau": 0.6}), ("dgcwgmf", {"tau": 0.3, "tau_warmup_rounds": 4})]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_stack(trees):
    """A list of k JAX pytrees -> one port pytree of [k, ...] tensors."""
    return jax.tree_util.tree_map(
        lambda *xs: torch.from_numpy(np.stack([np.asarray(x) for x in xs])), *trees)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _flat(tree):
    """A port tree (or ``{}``, an unused field) -> its flat stack (or ``{}``)."""
    return LAYOUT.flatten(tree) if _leaves(tree) else tree


def _flat_fields(state):
    return type(state)(*(_flat(f) for f in state))


def _tree(flat):
    """A flat stack (or ``{}``) -> the port tree of its leaves' views."""
    return LAYOUT.unflatten(flat) if torch.is_tensor(flat) else flat


def _staged_scores(tcfg, tstate, tgrad, tgbar, t):
    """The port's GMF score and per-client threshold of every leaf, from
    the round's input state (the selection the boundary check refers to)."""
    scheme = ts.resolve(tcfg)
    ops = tstages.elementwise_ops(tcfg)
    m, extra = scheme.fusion.pre(tcfg, tstate.m, tgbar)
    value, _, _ = scheme.compensator.accumulate(tcfg, ops, tstate.u, tstate.v, tgrad, extra)
    ctx = tstages.StageCtx(round_idx=t, gbar_prev=tgbar, local_steps=1.0, mean_steps=1.0,
                           tau_override=None, layout=LAYOUT)
    scores, _ = scheme.fusion.scores(tcfg, value, m, ctx)
    out = []
    for z in _leaves(_tree(scores)):
        za = z.abs().float()
        ref = (za.reshape(K, -1) if tcfg.selector == "exact" else tsp.strided_sample_nd(za))
        thr = tsp.exact_threshold(ref, tsp.num_keep(ref.shape[1], tcfg.rate))
        out.append((za.reshape(K, -1), thr))
    return out


def _close(got, want, exact, skip=None):
    got = got.numpy().reshape(want.shape)
    if skip is not None:
        got, want = got[~skip], want[~skip]
    if exact:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


# every preset × selector × use_kernels, but the τ-warmup variant's fused
# path (eager Pallas interpretation is slow) with the exact selector only
GRID = [(c, sel, uk) for c in CASES for sel in ("exact", "sampled") for uk in (False, True)
        if not (c[1].get("tau_warmup_rounds") and sel == "sampled" and uk)]


@pytest.mark.parametrize("case, selector, use_kernels", GRID, ids=[
    f"{c[0]}{'_warmup' if c[1].get('tau_warmup_rounds') else ''}-{sel}-{uk}"
    for c, sel, uk in GRID])
def test_client_compress_and_server_aggregate(case, selector, use_kernels):
    scheme, extra = case
    kw = dict(scheme=scheme, rate=0.1, selector=selector, use_kernels=use_kernels, **extra)
    jcfg, tcfg = js.CompressionConfig(**kw), ts.CompressionConfig(**kw)
    gmf = scheme == "dgcwgmf"
    exact = not gmf and not use_kernels
    rng = np.random.default_rng(7)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jstate1, jsstate = js.init_states(jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    jstates = [jstate1] * K
    jgbar = {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()}
    # Eager JAX runs op by op, unfused, which the bitwise cases need. The
    # non-GMF Pallas path is compiled once per config under jit instead of
    # traced at every call. The fused GMF path stays eager: under jit XLA
    # fuses the score outside the kernel and inside it differently, and the
    # JAX kernel's mask then misses elements at the threshold.
    jcompress = functools.partial(js.client_compress, jcfg)
    if use_kernels and not gmf:
        jcompress = jax.jit(jcompress)
    for t in range(3):
        grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
                 for _ in range(K)]
        # -- JAX, one client at a time --------------------------------------
        outs = [jcompress(jstates[i], jax.tree_util.tree_map(jnp.asarray, grads[i]), jgbar, t)
                for i in range(K)]
        g_sum = jax.tree_util.tree_map(lambda *xs: jnp.sum(jnp.stack(xs), axis=0),
                                       *[o[0] for o in outs])
        jbcast, jsstate_new, jainfo = js.server_aggregate(jcfg, jsstate, g_sum, float(K))
        # -- port, the [K, ...] stack at once from the same state -------------
        tstate = _flat_fields(_port_stack(jstates))
        tgrad = _flat(_port_stack(grads))
        tgbar = _flat(_port_stack([jgbar]))[0]
        tsstate = _port_stack([jsstate])
        tsstate = _flat_fields(jax.tree_util.tree_map(lambda x: x[0], tsstate))
        tG, tnew, tinfo = ts.client_compress(tcfg, tstate, tgrad, tgbar, t, layout=LAYOUT)
        tbcast, tsnew, tainfo = ts.server_aggregate(tcfg, tsstate, tG.sum(0), float(K))
        tG, tbcast = _tree(tG), _tree(tbcast)

        assert tinfo.upload_nnz.tolist() == [int(o[2].upload_nnz) for o in outs]
        jG = _port_stack([o[0] for o in outs])
        flips = []
        if gmf:
            sel = _staged_scores(tcfg, tstate, tgrad, tgbar, t)
        for li, (a, b) in enumerate(zip(_leaves(tG), _leaves(jG), strict=True)):
            fl = ((a != 0) != (b != 0)).reshape(K, -1)
            if fl.any():
                assert gmf, f"non-GMF mask differs in leaf {li} round {t}"
                z, thr = sel[li]
                rel = ((z - thr[:, None]).abs() / thr[:, None])[fl]
                assert bool((rel <= 1e-5).all()), f"mask flip off the boundary: {rel}"
            flips.append(fl.reshape(a.shape).numpy())
        for a, b, f in zip(_leaves(tG), _leaves(jG), flips, strict=True):
            _close(a, b.numpy(), exact, f)
        jnew = _port_stack([o[1] for o in outs])
        for field in ("u", "v", "m"):
            tl, jl = _leaves(_tree(getattr(tnew, field))), _leaves(getattr(jnew, field))
            assert len(tl) == len(jl)
            for a, b, f in zip(tl, jl, flips, strict=False):
                _close(a, b.numpy(), exact, f if field != "m" else None)
        any_flip = [f.any(axis=0) for f in flips]
        for a, b, f in zip(_leaves(tbcast), _leaves(_np(jbcast)), any_flip, strict=True):
            _close(a, b, exact, f)
        for a, b in zip(_leaves(_tree(tsnew.momentum)), _leaves(_np(jsstate_new.momentum)),
                        strict=True):
            _close(a, b, exact, None)
        if not any(f.any() for f in flips):
            assert int(tainfo.download_nnz) == int(jainfo.download_nnz)
            assert int(tainfo.union_nnz) == int(jainfo.union_nnz)
        jstates = [o[1] for o in outs]
        jsstate, jgbar = jsstate_new, jbcast


def test_tau_zero_gmf_equals_dgc():
    """The paper's degenerate case, as the JAX package tests it: dgcwgmf at
    τ = 0 selects exactly the dgc mask."""
    rng = np.random.default_rng(3)
    grads = LAYOUT.flatten({k: torch.from_numpy(rng.normal(size=(K,) + s).astype(np.float32))
                            for k, s in SHAPES.items()})
    zeros = {k: torch.zeros(s) for k, s in SHAPES.items()}
    outs = []
    for scheme in ("dgc", "dgcwgmf"):
        cfg = ts.CompressionConfig(scheme=scheme, rate=0.1, tau=0.0)
        state, _ = ts.init_states(cfg, zeros)
        state = jax.tree_util.tree_map(lambda x: x.expand((K,) + x.shape).clone(), state)
        outs.append(ts.client_compress(cfg, state, grads, LAYOUT.flatten(zeros), 0,
                                       layout=LAYOUT))
    for a, b in zip(_leaves(outs[0][0]), _leaves(outs[1][0]), strict=True):
        assert torch.equal(a, b)
