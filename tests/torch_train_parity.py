"""Shared routines of the training parity tests (``test_torch_lmtask_*.py``,
``test_torch_train_step*.py``): ``LMTask`` through each package's
``FLSimulator``, and one ``make_train_step`` step, on JAX-initialised
params converted leaf for leaf and the same synthetic token streams.

Tolerances, per leaf: max |port − JAX| ≤ REL × max |JAX|. In float32 REL
is 1e-5 (the frameworks sum matrix products in other orders, and jitted
JAX contracts a·x + y into one rounding, ROADMAP R3). In bfloat16 the
runs that feed the port JAX's gradients hold the compression state and
the counts exactly; the held-out loss, which each side computes with its
own bf16 forward, within BF16_REL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrain
from repro.core import CompressionConfig as JComp
from repro.dist import step as jstep
from repro.fl import FLConfig as JFL
from repro.fl import FLSimulator as JSim
from repro.fl import LMTask as JTask
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.core import CompressionConfig as TComp
from repro_torch.dist import step as tstep
from repro_torch.fl import FLConfig as TFL
from repro_torch.fl import FLSimulator as TSim
from repro_torch.fl import LMTask as TTask
from repro_torch.utils import tree_leaves
from repro_torch.utils.convert import from_jax_params
from repro_torch.utils.flat import FlatLayout

REL = 1e-5
BF16_REL = 3e-2
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(arch, dtype="float32"):
    """The JAX and port ``smoke()`` configs of ``arch`` at ``dtype``."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if dtype != "float32":
        jcfg = dataclasses.replace(jcfg, dtype=dtype, param_dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype, param_dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def jax_params(jcfg, seed=0):
    """(JAX params, numpy copy) from ``PRNGKey(seed)``."""
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def to_torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() if k in ("tokens", "labels")
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def leaf_errors(tree, jtree, *, dtypes=True):
    """Per leaf: max |port − JAX| / max |JAX|, with the dtypes compared
    (unless ``dtypes=False``)."""
    out = []
    for got, want in zip(tree_leaves(tree), jax.tree_util.tree_leaves(jtree), strict=True):
        if dtypes:
            assert got.dtype == TORCH_DTYPES[str(want.dtype)], (got.dtype, want.dtype)
        w = np.asarray(want, np.float64)
        g = got.detach().double().cpu().numpy()
        assert g.shape == w.shape
        out.append(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
    return out


def boundary_flips(tree, jtree, *, rel=REL):
    """The entries, over all leaves, where port and JAX differ by more than
    ``rel`` of the leaf's largest magnitude: where a score that ties a
    top-k threshold in one package falls just below it in the other."""
    flips = 0
    for got, want in zip(tree_leaves(tree), jax.tree_util.tree_leaves(jtree), strict=True):
        w = np.asarray(want, np.float64)
        g = got.detach().double().cpu().numpy().reshape(w.shape)
        flips += int((np.abs(g - w) > rel * max(np.abs(w).max(), 1e-30)).sum())
    return flips


def state_errors(flat, params, jtree):
    """``leaf_errors`` of a flat ``[n, N]`` state field (a tuple of them for
    a tree of mixed dtypes) against the reference's ``[n, ...]`` tree."""
    from repro_torch.utils.flat import FlatLayout

    return leaf_errors(FlatLayout.of(params).unflatten(flat), jtree)


def flat_dtypes(x):
    return sorted({str(t.dtype).replace("torch.", "") for t in tree_leaves(x)})


def jax_dtypes(x):
    return sorted({str(t.dtype) for t in jax.tree_util.tree_leaves(x)})


def feed_jax_grads(monkeypatch, jit_grads=True):
    """Feed the port's round engines JAX's client gradients: JAX's
    ``RoundEngine._grads`` stashes each call's result (jitted unless
    ``jit_grads=False``) and the port's pops them in call order, so the
    JAX run must go first, eagerly, inside the context this returns."""
    from repro.fl import engine as jengine
    from repro_torch.fl import engine as tengine

    stash = []
    real = jengine.RoundEngine._grads
    jitted = {}

    def keep(self, params, batches):
        if jit_grads:
            fn = jitted.setdefault(id(self), jax.jit(lambda p, b: real(self, p, b)))
            with jax.disable_jit(False):
                g = fn(params, batches)
        else:
            g = real(self, params, batches)
        stash.append(jax.tree_util.tree_map(np.asarray, g))
        return g

    monkeypatch.setattr(jengine.RoundEngine, "_grads", keep)
    monkeypatch.setattr(tengine.RoundEngine, "_grads", lambda self, params, batches:
                        from_jax_params(stash.pop(0), layout="transformer"))
    return jax.disable_jit()


def run_lmtask(arch, *, dtype="float32", jax_grads=None, jit_grads=True, fl_kw=None,
               comp_kw=None, port_fl_kw=None, group=None):
    """Two FL rounds of dgcwgmf (rate 0.1, 4 clients, 2 a round, batch 2,
    sequence 16, lr 0.1) through ``LMTask`` in both packages -> (JAX sim,
    port sim, JAX task, port task). With ``jax_grads`` (a pytest monkeypatch)
    JAX runs its rounds eagerly (its client gradients jitted, unless
    ``jit_grads=False``) and the port's engine is fed JAX's client
    gradients, round by round, so that everything after the gradient is
    compared on equal inputs. ``fl_kw`` / ``comp_kw`` replace or add
    ``FLConfig`` / ``CompressionConfig`` fields on both sides (a backend, a
    topology, a scheme), ``port_fl_kw`` on the port's alone (its shard
    backend at one rank, which is JAX's vmap); ``group`` is the port's
    process group."""
    import contextlib

    eager = (feed_jax_grads(jax_grads, jit_grads) if jax_grads is not None
             else contextlib.nullcontext())
    jcfg, tcfg = configs(arch, dtype)
    jp, np_params = jax_params(jcfg)
    fl = {**dict(num_clients=4, rounds=2, clients_per_round=2, batch_size=2, learning_rate=0.1,
                 seed=0), **(fl_kw or {})}
    comp = {**dict(scheme="dgcwgmf", rate=0.1), **(comp_kw or {})}
    jtask = JTask(jcfg, num_clients=fl["num_clients"], batch_size=2, seq_len=16)
    ttask = TTask(tcfg, num_clients=fl["num_clients"], batch_size=2, seq_len=16, device="cpu")
    jsim = JSim(JFL(**fl), JComp(**comp), lambda key: jp, jtask.loss_fn)
    tsim = TSim(TFL(**{**fl, **(port_fl_kw or {})}), TComp(**comp),
                lambda gen: from_jax_params(np_params, layout="transformer"), ttask.loss_fn,
                device="cpu", group=group)
    with eager:
        jsim.run(jtask.batch_provider)
    tsim.run(ttask.batch_provider)
    return jsim, tsim, jtask, ttask


def check_lmtask(arch, *, dtype="float32", **kw):
    """Cohorts, nnz and ledger bytes exact (float32) and params within REL
    of JAX's after the rounds; the state's dtypes equal the reference's."""
    jsim, tsim, jtask, ttask = run_lmtask(arch, dtype=dtype, **kw)
    assert len(jsim.history) == len(tsim.history)
    for jr, tr in zip(jsim.history, tsim.history, strict=True):
        # the ledger's bytes are the counts times the bytes a value: exact
        # bytes every round are exact counts
        assert tr["comm_gb"] == jr["comm_gb"], arch
    assert tsim.ledger.summary() == jsim.ledger.summary()
    if dtype == "float32":
        assert max(leaf_errors(tsim.params, jsim.params)) <= REL, arch
    else:  # the port's params keep their dtype (ROADMAP R13)
        assert "bfloat16" in flat_dtypes(tsim.params) and "bfloat16" not in jax_dtypes(
            jsim.params)
        assert max(leaf_errors(tsim.params, jsim.params, dtypes=False)) <= 2.0**-7, arch
    for field in ("u", "v", "m"):
        assert flat_dtypes(getattr(tsim.cstates, field)) == jax_dtypes(
            getattr(jsim.cstates, field)), (arch, field)
    assert flat_dtypes(tsim.gbar_prev) == jax_dtypes(jsim.gbar_prev), arch
    # the held-out batch and the task's own loss agree too
    for k, v in jtask.held_out.items():
        assert np.array_equal(ttask.held_out[k].numpy(), np.asarray(v)), (arch, k)
    with jax.disable_jit():  # the reference's scan refuses float32 params at bfloat16
        jl = float(jtask.loss_fn(jsim.params, jtask.held_out))
    tl = ttask.held_out_loss(tsim.params)
    assert abs(tl - jl) <= (REL if dtype == "float32" else BF16_REL) * abs(jl), (arch, tl, jl)
    return jsim, tsim


def train_configs(sync, **extra):
    kw = dict(learning_rate=0.05, total_steps=10, grad_sync=sync, lr_schedule="cosine",
              warmup_steps=1)
    kw.update(extra)
    return JTrain(**kw), TTrain(**kw)


def one_step(arch, sync, *, dtype="float32", scheme="dgcwgmf", use_kernels=False,
             jax_grads=None, meshes=None, comp_kw=None):
    """One step of ``make_train_step`` in both packages on the same batch ->
    (JAX state, port state, [(JAX metrics, port metrics)]). With
    ``jax_grads`` (a pytest monkeypatch) both steps take JAX's gradient at
    the initial params, G: the JAX step runs eagerly on a loss whose
    gradient is exactly G (the sum of params times G, leaf by leaf), and
    the port's step is fed G, so the compression, the server step and the
    update are compared on equal inputs (the metrics' loss is then that
    stand-in's). ``meshes`` (JAX mesh, port mesh) runs both steps over a
    mesh: JAX's state and batch laid out by its specs, the port's rank
    taking its local pieces (one rank: the whole). ``comp_kw``: more
    ``CompressionConfig`` fields, the same on both sides."""
    import contextlib

    from repro_torch.data.pipeline import SyntheticLMStream

    jcfg, tcfg = configs(arch, dtype)
    jp, np_params = jax_params(jcfg)
    jt, tt = train_configs(sync)
    jc = JComp(scheme=scheme, rate=0.1, use_kernels=use_kernels, **(comp_kw or {}))
    tc = TComp(scheme=scheme, rate=0.1, use_kernels=use_kernels, **(comp_kw or {}))
    stream = SyntheticLMStream(vocab_size=jcfg.vocab_size, seq_len=16, batch_size=4, seed=0,
                               num_codebooks=jcfg.num_codebooks, num_patches=jcfg.num_patches,
                               d_model=jcfg.d_model)
    b = next(stream)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    eager = contextlib.nullcontext()
    if jax_grads is not None:
        loss_fn = jstep.make_loss_fn(jcfg)
        _, jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp, jb)
        tg = from_jax_params(jax.tree_util.tree_map(np.asarray, jg), layout="transformer")

        def linear(cfg, mesh=None):
            def loss(params, batch):
                pairs = zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(jg),
                            strict=True)
                return sum(jnp.sum(x * g).astype(jnp.float32) for x, g in pairs), \
                    jnp.float32(0.0)
            return loss

        real = tstep._value_and_grad
        jax_grads.setattr(jstep, "make_loss_fn", linear)
        jax_grads.setattr(tstep, "_value_and_grad",
                          lambda f, p, batch: (real(f, p, batch)[0], tg))
        eager = jax.disable_jit()
    jmesh, tmesh = meshes or (None, None)
    jst = jstep.init_train_state(jcfg, jt, jc, jp, jmesh)
    tst = tstep.init_train_state(tcfg, tt, tc, from_jax_params(np_params, layout="transformer"),
                                 tmesh)
    tb = to_torch_batch(b)
    if jmesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        from repro.dist import sharding as jshr
        from repro_torch.dist import sharding as tshr

        def put(tree, specs):
            return jax.device_put(tree, jax.tree_util.tree_map(
                lambda s: NamedSharding(jmesh, s), specs,
                is_leaf=lambda x: isinstance(x, PartitionSpec)))

        jst = put(jst, jstep.train_state_specs(jcfg, jt, jc, jp, jmesh))
        jb = put(jb, jshr.train_batch_specs(jcfg, jmesh))
        tb = tshr.local_tree(tb, tshr.named_shardings(
            tmesh, tstep.step_batch_specs(tcfg, tt, tmesh)))
    tfn = tstep.make_train_step(tcfg, tt, tc, tmesh)
    with eager:
        jst, jm = jax.jit(jstep.make_train_step(jcfg, jt, jc, jmesh))(jst, jb)
    tst, tm = tfn(tst, tb)
    return jst, tst, [(jm, tm)]
