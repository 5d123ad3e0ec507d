"""The port's keyed stages — the ``randomk`` selector, the ``probquant``
wire and the ``hadamard`` rotation — against the JAX package's.

The port does not reproduce ``jax.random`` streams: each stage draws from a
counter-based hash of its key chain (``repro_torch.utils.draws``). So each
stage is held twice:

* **Twins.** With JAX's own draws injected through the stage's draw method
  (``RandomKSelector.uniforms``, ``ProbQuantWire.uniforms``,
  ``HadamardRotation.diagonal``), the results are **bitwise** JAX's: the
  masks, payloads and V of ``randomk``, the ternary round trip and its
  error-feedback fold, the rotation and its inverse (the same float32
  operations in the same order; the FWHT in the reference's butterfly
  order). ``dgc`` + hadamard + int8 is held bitwise as a whole scheme.
  ``dgcwgmf`` + probquant's GMF norms are sums in another order
  (tests/test_torch_schemes.py), so there the masks and nnz are exact
  and the values within rtol 1e-5 / atol 1e-6 (a ternary value is a block
  max of such values).
* **The port's own draws**, by the reference's invariants: ``randomk``
  shares one mask across clients, keyed per (round, leaf), at density r
  (within 5σ); probquant's values are ternary per block, unbiased (the
  mean over 10,000 keyed rounds within a 6σ band, as
  tests/test_properties.py), decorrelated across clients, 0.25 byte a
  value; the rotation preserves norms (rtol 1e-5), inverts within 1e-6 of
  the input's scale, is keyed per (round, leaf) and stays finite on
  degenerate inputs.

Payload magnitudes stay in float32's normal range (ROADMAP R4: XLA's CPU
backend flushes subnormal results to zero, torch does not).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import CompressionConfig as JComp
from repro.core import client_compress as jcompress
from repro.core import stages as jstages
from repro.core.state import ClientState as JState
from repro_torch.core import CompressionConfig as TComp
from repro_torch.core import client_compress as tcompress
from repro_torch.core import stages as tstages
from repro_torch.core.state import ClientState as TState
from repro_torch.utils import quant as tquant
from repro_torch.utils.flat import FlatLayout

# leaves of 300 (two int8 blocks, pads to 512), 80, 16 x 40, 3 x 171, 1 and 256
SHAPES = {"a": (300,), "b": (80,), "c": (16, 40), "d": (3, 171), "e": (1,), "f": (256,)}
NAMES = sorted(SHAPES)
LAYOUT = FlatLayout.of({k: torch.zeros(s) for k, s in SHAPES.items()})
K = 3
TOL = dict(rtol=1e-5, atol=1e-6)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _tree(seed, k=K, density=1.0, scale=1.0):
    rng = np.random.default_rng(seed)
    out = {}
    for n, s in SHAPES.items():
        x = rng.normal(size=(k, *s)) * scale * np.exp(rng.uniform(-3, 3, size=(k, *s)))
        out[n] = (x * (rng.random((k, *s)) < density)).astype(np.float32)
    return out


def _flat(tree):
    return LAYOUT.flatten({n: torch.from_numpy(np.ascontiguousarray(x)) for n, x in tree.items()})


def _row(tree, r):
    return {n: jnp.asarray(x[r]) for n, x in tree.items()}


def _jflat(trees):
    """JAX trees (one per client) -> a [k, N] numpy stack in the port's order."""
    return np.stack([np.concatenate([np.asarray(t[n]).reshape(-1) for n in NAMES])
                     for t in trees])


def _assert_bitwise(got, want):
    assert np.array_equal(_bits(got.numpy()), _bits(want))


# ---------------------------------------------------------------------------
# JAX's draws
# ---------------------------------------------------------------------------


def _jax_randomk_uniforms(t):
    key = jax.random.fold_in(jax.random.PRNGKey(17), jnp.asarray(t, jnp.int32))
    return np.concatenate([np.asarray(jax.random.uniform(jax.random.fold_in(key, i),
                                                         SHAPES[n])).reshape(-1)
                           for i, n in enumerate(NAMES)])


def _jax_probquant_uniforms(seed, t, clients):
    """[k, N]: per (round, leaf, client) the uniforms JAX's ternary codec
    draws for the leaf's padded blocks, cut to the leaf."""
    rows = []
    for c in clients:
        row = []
        for i, n in enumerate(NAMES):
            size = int(np.prod(SHAPES[n]))
            key = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.asarray(t, jnp.int32))
            key = jax.random.fold_in(jax.random.fold_in(key, i), jnp.asarray(c, jnp.int32))
            blocks = -(-size // 256)
            row.append(np.asarray(jax.random.uniform(key, (blocks, 256))).reshape(-1)[:size])
        rows.append(np.concatenate(row))
    return torch.from_numpy(np.stack(rows))


def _jax_diagonal(cfg, t, layout=LAYOUT):
    rot = jstages.get_stage("rotation", "hadamard")
    return torch.from_numpy(np.concatenate([
        np.asarray(rot._diag(cfg, rot._padded(n), jnp.asarray(t), i))
        for i, n in enumerate(layout.sizes)]))


# ---------------------------------------------------------------------------
# randomk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("adaptive", [False, True])
def test_randomk_twin_bitwise(monkeypatch, adaptive):
    sel = tstages.get_stage("selector", "randomk")
    jcfg, tcfg = JComp(scheme="randomk", rate=0.2), TComp(scheme="randomk", rate=0.2)
    rates = np.asarray([0.05, 0.2, 0.7], np.float32)
    v = _tree(0)
    for t in range(3):
        monkeypatch.setattr(sel, "uniforms", lambda cfg, r, layout, t=t: torch.from_numpy(
            _jax_randomk_uniforms(t)))
        g = _tree(10 + t)
        want = [jcompress(jcfg, JState(u={}, v=_row(v, r), m={}), _row(g, r),
                          _row(g, r), t, rate=jnp.float32(rates[r]) if adaptive else None)
                for r in range(K)]
        G, st, info = tcompress(tcfg, TState(u={}, v=_flat(v), m={}), _flat(g), _flat(g)[0], t,
                                rates=torch.from_numpy(rates) if adaptive else None,
                                layout=LAYOUT)
        _assert_bitwise(G, _jflat([w[0] for w in want]))
        _assert_bitwise(st.v, _jflat([w[1].v for w in want]))
        assert info.upload_nnz.tolist() == [int(w[2].upload_nnz) for w in want]
        v = {n: np.stack([np.asarray(w[1].v[n]) for w in want]) for n in NAMES}


def test_randomk_own_draw_is_shared_keyed_and_at_rate():
    sel = tstages.get_stage("selector", "randomk")
    cfg = TComp(scheme="randomk", rate=0.1)
    big = FlatLayout.of({"w": torch.zeros(400, 500), "b": torch.zeros(200_000)})
    masks = [sel.select(cfg, torch.zeros(4, big.total), t, big) for t in range(3)]
    for m in masks:
        assert m.shape == (4, big.total)
        assert all(torch.equal(m[0], m[r]) for r in range(1, 4))  # one mask, every client
        for seg in big.segments(m[0]):  # density r within 5 sigma per leaf
            n = seg.numel()
            assert abs(float(seg.sum()) - 0.1 * n) <= 5 * np.sqrt(n * 0.1 * 0.9)
    assert not torch.equal(masks[0], masks[1])  # keyed per round
    w, b = big.segments(masks[0][0])
    assert not torch.equal(w[:1000], b[:1000])  # keyed per leaf
    assert torch.equal(masks[0], sel.select(cfg, torch.zeros(4, big.total), 0, big))
    # per-client rates share the uniforms: nested masks, each at its rate
    rates = torch.tensor([0.05, 0.1, 0.5])
    dyn = sel.select(cfg, torch.zeros(3, big.total), 0, big, rates=rates)
    assert torch.equal(dyn[1], masks[0][0])
    assert bool((dyn[0] <= dyn[1]).all()) and bool((dyn[1] <= dyn[2]).all())
    for r, rate in enumerate(rates.tolist()):
        n = big.total
        assert abs(float(dyn[r].sum()) - rate * n) <= 5 * np.sqrt(n * rate * (1 - rate))


# ---------------------------------------------------------------------------
# probquant
# ---------------------------------------------------------------------------


def _jctx(t, c):
    return jstages.StageCtx(round_idx=jnp.asarray(t), gbar_prev=None, local_steps=1.0,
                            mean_steps=1.0, tau_override=None, client_id=jnp.asarray(c))


def _tctx(t, ids):
    return tstages.StageCtx(round_idx=t, gbar_prev=None, local_steps=1.0, mean_steps=1.0,
                            tau_override=None, layout=LAYOUT, client_ids=ids)


@pytest.mark.parametrize("t", [0, 4])
def test_probquant_twin_bitwise(monkeypatch, t):
    wire = tstages.get_stage("wire", "probquant")
    jcfg, tcfg = JComp(scheme="dgc", wire_dtype="probquant"), TComp(scheme="dgc",
                                                                     wire_dtype="probquant")
    clients = [7, 0, 12]
    u = _jax_probquant_uniforms(tcfg.probquant_seed, t, clients)
    monkeypatch.setattr(wire, "uniforms", lambda cfg, layout, ctx: u)
    g, v = _tree(1, density=0.3), _tree(2)
    want = [jstages.get_stage("wire", "probquant").encode(
        jcfg, _row(g, r), JState(u={}, v=_row(v, r), m={}), _jctx(t, c))
        for r, c in enumerate(clients)]
    got, st = wire.encode(tcfg, _flat(g), TState(u={}, v=_flat(v), m={}), LAYOUT,
                          _tctx(t, torch.tensor(clients)))
    _assert_bitwise(got, _jflat([w[0] for w in want]))
    _assert_bitwise(st.v, _jflat([w[1].v for w in want]))
    # the one-tensor codec on the same draws
    for r, c in enumerate(clients):
        leaf = torch.from_numpy(g["c"][r])
        uc = LAYOUT.segments(u[r])[NAMES.index("c")]
        _assert_bitwise(tquant.roundtrip_ternary_blocks(leaf, uc), np.asarray(want[r][0]["c"]))


def test_probquant_own_draws_are_ternary_unbiased_and_per_client():
    wire = tstages.get_stage("wire", "probquant")
    cfg = TComp(scheme="dgc", wire_dtype="probquant")
    assert wire.value_bytes == 0.25 and wire.stochastic
    x = torch.from_numpy(_tree(5, k=1, density=0.5)["f"][0])  # one 256-block
    one = FlatLayout.of({"f": x})
    ctx = lambda t, ids=None: tstages.StageCtx(round_idx=t, gbar_prev=None, local_steps=1.0,
                                               mean_steps=1.0, tau_override=None, layout=one,
                                               client_ids=ids)
    n = 10_000
    draws = torch.cat([wire.roundtrip_ctx(cfg, x[None], one, ctx(t)) for t in range(n)])
    amax = float(x.abs().max())
    # ternary: every value is 0 or ±(the block's max), with x's sign
    assert bool(((draws == 0) | (draws.abs() == amax)).all())
    assert bool((torch.sign(draws) * torch.sign(x) >= 0).all())
    # unbiased: the mean over n keyed rounds sits in a 6-sigma band around x
    mean = draws.double().mean(0).numpy()
    xs = x.double().numpy()
    p = np.abs(xs) / amax
    assert np.all(np.abs(mean - xs) <= 6.0 * amax * np.sqrt(p * (1 - p) / n) + 1e-5 * amax)
    # decorrelated: clients given the same payload in one round draw different noise
    per_client = wire.roundtrip_ctx(cfg, x.expand(4, -1), one, ctx(3, torch.arange(4)))
    assert len({tuple(row.tolist()) for row in per_client}) == 4
    # the context-free round trip is one fixed draw
    assert torch.equal(wire.roundtrip(x[None], one), wire.roundtrip(x[None], one))
    # all-zero blocks decode to exact zeros
    assert torch.equal(wire.roundtrip(torch.zeros(2, LAYOUT.total), LAYOUT),
                       torch.zeros(2, LAYOUT.total))


def test_probquant_engine_threads_client_ids():
    """Two clients with the same gradient through the engine's scheme call
    get different payloads; the ledger charges 0.25 byte a value."""
    from repro_torch.core import resolve

    cfg = TComp(scheme="none", wire_dtype="probquant")
    scheme = resolve(cfg)
    g = torch.from_numpy(_tree(6, k=1)["c"]).reshape(1, -1).expand(2, -1).contiguous()
    one = FlatLayout.of({"c": torch.zeros(16, 40)})
    state = TState(u={}, v={}, m={})
    G, _, _ = scheme.client_compress(state, g, torch.zeros(640), 0, client_ids=torch.tensor(
        [0, 1]), layout=one)
    assert not torch.equal(G[0], G[1])
    same, _, _ = scheme.client_compress(state, g, torch.zeros(640), 0, layout=one)
    assert torch.equal(same[0], same[1])  # no ids: one stream, as the reference
    cost = scheme.cost_model()
    assert cost.value_bytes == 0.25
    assert float(cost.payload_bytes(640, 640)) == 640 * 0.25


# ---------------------------------------------------------------------------
# hadamard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [0, 3])
def test_hadamard_twin_bitwise(monkeypatch, t):
    rot = tstages.get_stage("rotation", "hadamard")
    jrot = jstages.get_stage("rotation", "hadamard")
    jcfg, tcfg = JComp(scheme="dgc"), TComp(scheme="dgc")
    d = _jax_diagonal(jcfg, t)
    monkeypatch.setattr(rot, "diagonal", lambda cfg, r, layout: d)
    x = _tree(7, scale=1e-3)
    y, rotated = rot.forward(tcfg, _flat(x), t, LAYOUT)
    assert rotated.sizes == tuple(jrot.wire_size(n) for n in LAYOUT.sizes)
    want_y = [[np.asarray(jrot.forward(jcfg, jnp.asarray(x[n][r]), jnp.asarray(t), i))
               for i, n in enumerate(NAMES)] for r in range(K)]
    _assert_bitwise(y, np.stack([np.concatenate(row) for row in want_y]))
    back = rot.inverse(tcfg, y, t, LAYOUT)
    want_back = [{n: jrot.inverse(jcfg, jnp.asarray(want_y[r][i]), jnp.asarray(t),
                                  jnp.asarray(x[n][r]), i) for i, n in enumerate(NAMES)}
                 for r in range(K)]
    _assert_bitwise(back, _jflat(want_back))


def test_hadamard_preserves_norms_inverts_and_is_keyed():
    rot = tstages.get_stage("rotation", "hadamard")
    cfg = TComp(scheme="dgc")
    for scale in (1e-6, 1.0, 1e6):
        x = _flat(_tree(8, scale=scale))
        y, rotated = rot.forward(cfg, x, 2, LAYOUT)
        assert y.shape == (K, sum(rot.wire_size(n) for n in LAYOUT.sizes))
        for a, b in zip(LAYOUT.segments(x), rotated.segments(y), strict=True):
            np.testing.assert_allclose(b.norm(dim=1).numpy(), a.norm(dim=1).numpy(),
                                       rtol=1e-5, atol=1e-30)
        back = rot.inverse(cfg, y, 2, LAYOUT)
        scale_of = x.abs().max().item()
        np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=1e-5, atol=1e-6 * scale_of)
    x = _flat(_tree(9))
    y0, rotated = rot.forward(cfg, x, 0, LAYOUT)
    assert not torch.equal(y0, rot.forward(cfg, x, 1, LAYOUT)[0])  # keyed per round
    d = rot.diagonal(cfg, 0, LAYOUT)
    a, f = rotated.segments(d)[NAMES.index("a")], rotated.segments(d)[NAMES.index("f")]
    assert not torch.equal(a[:256], f)  # keyed per leaf
    assert set(d.unique().tolist()) == {-1.0, 1.0}
    for bad in (torch.zeros(K, LAYOUT.total), torch.zeros(K, LAYOUT.total).index_fill(
            1, torch.tensor([3]), 1e30)):
        y, _ = rot.forward(cfg, bad, 0, LAYOUT)
        assert bool(torch.isfinite(y).all())
        assert bool(torch.isfinite(rot.inverse(cfg, y, 0, LAYOUT)).all())


def test_hadamard_groups_resnet56_leaves_by_padded_length():
    from repro_torch.models import resnet

    params = resnet.init_resnet(torch.Generator().manual_seed(0), depth=56, device="cpu")
    layout = FlatLayout.of(params)
    rot = tstages.get_stage("rotation", "hadamard")
    rotated, groups = rot.plan(layout)
    assert layout.num_leaves == 169 and len(groups) == 11
    assert [g.m for g in groups][0] == 16 and groups[-1].m == 65_536
    assert rotated.total == sum(rot.wire_size(n) for n in layout.sizes) == 1_515_504


# ---------------------------------------------------------------------------
# whole schemes, one client stack against JAX
# ---------------------------------------------------------------------------


def test_dgc_hadamard_int8_scheme_bitwise(monkeypatch):
    rot = tstages.get_stage("rotation", "hadamard")
    kw = dict(scheme="dgc", rate=0.1, rotation_stage="hadamard", wire_dtype="int8")
    jcfg, tcfg = JComp(**kw), TComp(**kw)
    u, v = _tree(20, scale=1e-2), _tree(21, scale=1e-2)
    for t in range(2):
        d = _jax_diagonal(jcfg, t)
        monkeypatch.setattr(rot, "diagonal", lambda cfg, r, layout, d=d: d)
        g = _tree(30 + t, scale=1e-2)
        want = [jcompress(jcfg, JState(u=_row(u, r), v=_row(v, r), m={}), _row(g, r),
                          _row(g, r), t) for r in range(K)]
        G, st, info = tcompress(tcfg, TState(u=_flat(u), v=_flat(v), m={}), _flat(g),
                                _flat(g)[0], t, layout=LAYOUT)
        _assert_bitwise(G, _jflat([w[0] for w in want]))
        _assert_bitwise(st.u, _jflat([w[1].u for w in want]))
        _assert_bitwise(st.v, _jflat([w[1].v for w in want]))
        wire_n = sum(rot.wire_size(n) for n in LAYOUT.sizes)
        assert info.upload_nnz.tolist() == [int(w[2].upload_nnz) for w in want] == [wire_n] * K
        u = {n: np.stack([np.asarray(w[1].u[n]) for w in want]) for n in NAMES}
        v = {n: np.stack([np.asarray(w[1].v[n]) for w in want]) for n in NAMES}


def test_dgcwgmf_probquant_scheme_matches_jax(monkeypatch):
    wire = tstages.get_stage("wire", "probquant")
    kw = dict(scheme="dgcwgmf", rate=0.1, tau=0.6, wire_dtype="probquant")
    jcfg, tcfg = JComp(**kw), TComp(**kw)
    clients = [2, 5, 9]
    u, v, m = _tree(40, scale=1e-2), _tree(41, scale=1e-2), _tree(42, scale=1e-2)
    g, gbar = _tree(43, scale=1e-2), _tree(44, k=1, scale=1e-2)
    t = 1
    uni = _jax_probquant_uniforms(tcfg.probquant_seed, t, clients)
    monkeypatch.setattr(wire, "uniforms", lambda cfg, layout, ctx: uni)
    want = [jcompress(jcfg, JState(u=_row(u, r), v=_row(v, r), m=_row(m, r)), _row(g, r),
                      _row(gbar, 0), t, client_id=jnp.asarray(c))
            for r, c in enumerate(clients)]
    G, st, info = tcompress(tcfg, TState(u=_flat(u), v=_flat(v), m=_flat(m)), _flat(g),
                            _flat(gbar)[0], t, client_ids=torch.tensor(clients), layout=LAYOUT)
    assert info.upload_nnz.tolist() == [int(w[2].upload_nnz) for w in want]
    # dgc zeroes U exactly on the mask: the masks are equal
    want_u = _jflat([w[1].u for w in want])
    assert np.array_equal(st.u.numpy() == 0, want_u == 0)
    np.testing.assert_allclose(st.u.numpy(), want_u, **TOL)
    np.testing.assert_allclose(G.numpy(), _jflat([w[0] for w in want]), **TOL)
    np.testing.assert_allclose(st.v.numpy(), _jflat([w[1].v for w in want]), **TOL)
    np.testing.assert_allclose(st.m.numpy(), _jflat([w[1].m for w in want]), **TOL)
