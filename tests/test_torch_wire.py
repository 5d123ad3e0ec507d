"""The port's wire codecs and top-k downlink against the JAX package's, on
the flat state (``repro_torch.utils.flat``).

* The float16, bfloat16 and int8 round trips and the error-feedback fold
  V ← V + (G − wire(G)) are elementwise float32 maths (the int8 scale a
  block max and a true division): they must be **bitwise** JAX's, compared
  as float32 bit patterns, on payload stacks whose leaves cross 256-entry
  block edges, hold all-zero blocks and 80-element leaves, and span
  magnitudes from 3e-33 to past float16's range. XLA's CPU backend flushes
  subnormal float32 results to zero and torch does not, so the payloads
  keep every result in float32's normal range: at 3e-33 an int8 block's
  scale (max / 127) is still normal.
* The ``topk`` downlink with its server residual: masks, residual,
  broadcast and ``download_nnz`` bitwise over successive rounds, per-tensor
  and global, under each wire.
* ``topk`` and ``dgcwgmf_dl`` over 3 simulator rounds on a model whose
  gradient is exact elementwise float32 (``c + p``): the ledger equal round
  by round (so the nnz too) and params within 1e-6 of each leaf's largest
  magnitude: the jitted JAX round contracts w − lr·g into a fused
  multiply-add (ROADMAP Queue 3) and the port does not, and ``dgcwgmf_dl``'s
  GMF norms are sums taken in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import CompressionConfig as JComp
from repro.core import stages as jstages
from repro.core.state import ClientState as JState
from repro.fl import FLConfig as JFL
from repro.fl import FLSimulator as JSim
from repro.utils import quant as jquant
from repro_torch.core import CompressionConfig as TComp
from repro_torch.core import stages as tstages
from repro_torch.core.state import ClientState as TState
from repro_torch.fl import FLConfig as TFL
from repro_torch.fl import FLSimulator as TSim
from repro_torch.utils import quant as tquant
from repro_torch.utils.convert import from_jax_params
from repro_torch.utils.flat import FlatLayout

# leaves of 300 (crosses a block edge), 80, 640, exactly 256, 1, 513 (three
# blocks, all zero in every client) and 3 x 171
SHAPES = {"a": (300,), "b": (80,), "c": (16, 40), "d": (256,), "e": (1,), "f": (3, 171),
          "z": (513,)}
LAYOUT = FlatLayout.of({k: torch.zeros(s) for k, s in SHAPES.items()})
K = 3
WIRES = ("float16", "bfloat16", "int8")


def _payload(seed, k=K, density=0.15):
    """A sparse payload tree of [k, *shape] float32 arrays: magnitudes from
    about 3e-33 to 1e6 (past float16's 65,504, and below its smallest
    subnormal), about ``density`` of them nonzero, leaf z all zero."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in SHAPES.items():
        x = rng.normal(size=(k, *shape)) * np.exp(rng.uniform(-74, 14, size=(k, *shape)))
        x *= rng.random((k, *shape)) < density
        if name == "z":
            x[:] = 0.0
        out[name] = x.astype(np.float32)
    out["a"][:, :4] = [65504.0, 65520.0, -3e-8, 2.0**-24]  # float16 max, overflow, tiny
    return out


def _flat(tree):
    return LAYOUT.flatten({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()})


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_bitwise(flat, tree):
    """Every leaf of the port's flat stack bitwise the JAX tree's."""
    got = LAYOUT.unflatten(flat)
    for name in SHAPES:
        assert np.array_equal(_bits(got[name].numpy()), _bits(tree[name])), name


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("seed", [0, 1])
def test_wire_roundtrip_bitwise(wire, seed):
    g = _payload(seed)
    want = {n: np.stack([np.asarray(jstages.get_stage("wire", wire).roundtrip(jnp.asarray(x[r])))
                         for r in range(K)]) for n, x in g.items()}
    got = tstages.get_stage("wire", wire).roundtrip(_flat(g), LAYOUT)
    _assert_bitwise(got, want)
    # a zero never decodes to a nonzero: the payload's nnz cannot grow
    flat = _flat(g)
    assert not bool(((got != 0) & (flat == 0)).any())
    assert torch.equal(LAYOUT.unflatten(got)["z"], torch.zeros(K, 513))


@pytest.mark.parametrize("wire", WIRES)
def test_wire_encode_folds_the_residual_into_v_bitwise(wire):
    g, v = _payload(2), _payload(3, density=1.0)
    jcfg, tcfg = JComp(scheme="dgc", wire_dtype=wire), TComp(scheme="dgc", wire_dtype=wire)
    want_g, want_v = {n: [] for n in SHAPES}, {n: [] for n in SHAPES}
    for r in range(K):
        jg = {n: jnp.asarray(x[r]) for n, x in g.items()}
        jv = {n: jnp.asarray(x[r]) for n, x in v.items()}
        out, st = jstages.get_stage("wire", wire).encode(jcfg, jg, JState(u={}, v=jv, m={}))
        for n in SHAPES:
            want_g[n].append(np.asarray(out[n]))
            want_v[n].append(np.asarray(st.v[n]))
    tout, tst = tstages.get_stage("wire", wire).encode(
        tcfg, _flat(g), TState(u={}, v=_flat(v), m={}), LAYOUT)
    _assert_bitwise(tout, {n: np.stack(x) for n, x in want_g.items()})
    _assert_bitwise(tst.v, {n: np.stack(x) for n, x in want_v.items()})
    assert tst.u == {} and tst.m == {}


def test_int8_codec_matches_the_reference_on_one_tensor():
    """``roundtrip_q8_blocks`` (one tensor) and ``quantize_q8`` bitwise the
    reference's, including the tail block and an all-zero block."""
    x = _payload(4)["f"][0].copy()
    x[1] = 0.0
    got = tquant.roundtrip_q8_blocks(torch.from_numpy(x))
    assert np.array_equal(_bits(got.numpy()), _bits(jquant.roundtrip_q8_blocks(jnp.asarray(x))))
    q, s = tquant.quantize_q8(torch.from_numpy(x), axis=-1)
    jq, js_ = jquant.quantize_q8(jnp.asarray(x), axis=-1)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(_bits(s.numpy()), _bits(js_))


def test_layout_blocks_start_at_each_leaf():
    nblocks, idx = LAYOUT.blocks(256)
    counts = [-(-int(np.prod(s)) // 256) for s in SHAPES.values()]
    assert nblocks == sum(counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    want = np.concatenate([np.arange(int(np.prod(s))) // 256 + b0
                           for s, b0 in zip(SHAPES.values(), starts, strict=True)])
    assert np.array_equal(idx.numpy(), want)


@pytest.mark.parametrize("wire", ("float32", *WIRES))
@pytest.mark.parametrize("per_tensor, rate", [(True, 0.1), (True, 0.3), (False, 0.1)])
def test_topk_downlink_bitwise_over_rounds(wire, per_tensor, rate):
    """Three successive broadcasts through the downlink, the residual
    carried by each package: masks, broadcast, residual, nnz bitwise."""
    kw = dict(scheme="dgcwgmf_dl", wire_dtype=wire, downlink_rate=rate, per_tensor=per_tensor)
    jcfg, tcfg = JComp(**kw), TComp(**kw)
    jdl, tdl = jstages.get_stage("downlink", "topk"), tstages.get_stage("downlink", "topk")
    jwire, twire = jstages.get_stage("wire", wire), tstages.get_stage("wire", wire)
    jres = {n: jnp.zeros(s, jnp.float32) for n, s in SHAPES.items()}
    tres = LAYOUT.zeros()
    for step in range(3):
        b = {n: x[0] for n, x in _payload(10 + step, k=1, density=0.4).items()}
        jout, jres, jnnz = jdl.apply(jcfg, jwire, jres, {n: jnp.asarray(x) for n, x in b.items()},
                                     None)
        tout, tres, tnnz = tdl.apply(tcfg, twire, tres, _flat(b), None, LAYOUT)
        _assert_bitwise(tout, jax.tree_util.tree_map(np.asarray, jout))
        _assert_bitwise(tres, jax.tree_util.tree_map(np.asarray, jres))
        assert int(tnnz) == int(jnnz) > 0


# ---------------------------------------------------------------------------
# three simulator rounds on a model with an exact elementwise gradient
# ---------------------------------------------------------------------------

MODEL = {"w": (24, 40), "b": (40,), "h": (40, 7)}
FL = dict(num_clients=5, rounds=3, clients_per_round=3, batch_size=1, learning_rate=0.5,
          seed=0)


def _init_np(seed=0):
    rng = np.random.default_rng(seed)
    return {n: (rng.normal(size=s) * 0.1).astype(np.float32) for n, s in MODEL.items()}


def _jax_loss(p, batch):
    # d/dp [sum(p * c) + 0.5 * sum(p^2)] = c + p, exact elementwise float32
    return sum(jnp.sum(p[n] * batch[n][0]) + 0.5 * jnp.sum(jnp.square(p[n])) for n in MODEL)


def _torch_loss(p, batch):
    return sum(torch.sum(p[n] * batch[n][0]) + 0.5 * torch.sum(torch.square(p[n]))
               for n in MODEL)


def _batches(to):
    def provide(t, ids, rng):
        return {n: to(rng.normal(size=(len(ids), 1, *s)).astype(np.float32))
                for n, s in MODEL.items()}

    return provide


def run_pair(fl_kw=None, **comp):
    """The same FL run in both packages from the same params and batches:
    (JAX simulator, port simulator)."""
    fl_kw = {**FL, **(fl_kw or {})}
    init = _init_np()
    jsim = JSim(JFL(**fl_kw), JComp(**comp), lambda key: {n: jnp.asarray(x)
                                                           for n, x in init.items()},
                _jax_loss)
    jsim.run(_batches(jnp.asarray))
    tsim = TSim(TFL(**fl_kw), TComp(**comp), lambda gen: from_jax_params(init, layout="lstm"),
                _torch_loss, device="cpu")
    tsim.run(_batches(torch.from_numpy))
    return jsim, tsim


def assert_runs_match(jsim, tsim, atol_rel=1e-6):
    """Ledger bytes equal round by round (so nnz too); params within
    ``atol_rel`` of each leaf's largest magnitude."""
    assert [r["comm_gb"] for r in tsim.history] == [r["comm_gb"] for r in jsim.history]
    assert tsim.ledger.upload_bytes == jsim.ledger.upload_bytes
    assert tsim.ledger.download_bytes == jsim.ledger.download_bytes
    for n in MODEL:
        got, want = tsim.params[n].numpy(), np.asarray(jsim.params[n])
        np.testing.assert_allclose(got, want, rtol=0, atol=atol_rel * np.abs(want).max())


def test_topk_preset_three_rounds():
    jsim, tsim = run_pair(scheme="topk", rate=0.1)
    assert_runs_match(jsim, tsim)
    keep = sum(max(1, int(np.ceil(0.1 * np.prod(s)))) for s in MODEL.values())
    assert all(min(r["upload_nnz"]) >= keep for r in tsim.history)


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_dgcwgmf_dl_three_rounds(wire):
    jsim, tsim = run_pair(scheme="dgcwgmf_dl", rate=0.1, tau=0.6, wire_dtype=wire,
                          downlink_rate=0.2)
    assert_runs_match(jsim, tsim)
    # the downlink ran: its residual holds what the clients have not seen
    # (held bitwise, from the same inputs, by the downlink test above)
    assert tsim.sstate.residual.shape == (tsim.layout.total,)
    assert int(torch.count_nonzero(tsim.sstate.residual)) > 0
