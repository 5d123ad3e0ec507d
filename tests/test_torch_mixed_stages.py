"""The compression stages that work across leaves or key their draws by
leaf, over a tree of mixed leaf dtypes (``GroupedLayout``: one flat stack
per dtype group).

The tree's bfloat16 and float32 leaves alternate, so the groups interleave
in the tree and no group but the first starts at a leaf of its own number.

Tolerances:
- **against the float32 tree** (the same values, every bfloat16 value cast
  to float32 exactly, in one ``FlatLayout``): bitwise. Each group's tree
  places (``leaf_ids``, ``tree_index``); global top-k's masks (static and
  per-client rates; normal draws, ties, mostly zeros) and the global top-k
  downlink; random-k's uniforms and masks; the probquant wire's keyed
  draws and its round trip; the Hadamard diagonal and the int8 round trip
  behind the rotation, through the grouped plan and one leaf at a time;
  FetchSGD's sketch (each entry hashed by its whole-tree index, the
  buckets summed in tree order), its heavy hitters and one whole FetchSGD
  step through ``Scheme``; the per-client keep tables of adaptive rates.
- **against the JAX package** on the same mixed tree (one client stack
  against JAX's ``client_compress`` per client): bitwise. Global top-k
  under ``dgc`` and ``dgcwgmf`` (static and per-client rates) and
  per-tensor top-k at per-client rates; and the keyed stages as twins fed
  JAX's draws (``RandomKSelector.uniforms``, ``ProbQuantWire.uniforms``,
  ``HadamardRotation.diagonal``, each returning its dtype group's leaves'
  draws): random-k, ``dgc`` + hadamard + int8, and ``dgc`` + probquant.
  FetchSGD's client sketch and server step bitwise JAX's (the sketch's
  buckets in ascending index order on the CPU).

Payload magnitudes stay in float32's normal range (ROADMAP R4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import CompressionConfig as JComp  # noqa: E402
from repro.core import client_compress as jcompress  # noqa: E402
from repro.core import resolve as jresolve  # noqa: E402
from repro.core import stages as jstages  # noqa: E402
from repro.core.state import ClientState as JState  # noqa: E402
from repro.core.state import ServerState as JServer  # noqa: E402
from repro_torch.core import CompressionConfig as TComp  # noqa: E402
from repro_torch.core import client_compress as tcompress  # noqa: E402
from repro_torch.core import resolve  # noqa: E402
from repro_torch.core import sketch as ts  # noqa: E402
from repro_torch.core import sparsify as tsp  # noqa: E402
from repro_torch.core import stages as tstages  # noqa: E402
from repro_torch.core.stages import StageCtx  # noqa: E402
from repro_torch.core.state import ClientState as TState  # noqa: E402
from repro_torch.core.state import ServerState  # noqa: E402
from repro_torch.utils.convert import from_jax_params  # noqa: E402
from repro_torch.utils.flat import FlatLayout, GroupedLayout  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
# bfloat16 and float32 leaves alternating in tree (sorted-name) order; "c"
# pads to 512 under the rotation and spans two int8 blocks
SHAPES = {"a": (6, 8), "b": (10,), "c": (300,), "d": (3, 7), "e": (40,), "f": (2, 2, 3)}
DTYPES = {"a": BF, "b": F32, "c": BF, "d": F32, "e": BF, "f": F32}
NAMES = sorted(SHAPES)
K = 3
MIXED = FlatLayout.of({n: torch.zeros(s, dtype=DTYPES[n]) for n, s in SHAPES.items()})
FLAT = FlatLayout.of({n: torch.zeros(s) for n, s in SHAPES.items()})
JNP = {BF: jnp.bfloat16, F32: jnp.float32}


def _tree(seed, k=K, scale=1.0, density=1.0):
    """numpy float32 ``[k, *shape]`` leaves, each bfloat16 leaf's values
    rounded to bfloat16 (so the float32 tree holds the same values)."""
    rng = np.random.default_rng(seed)
    out = {}
    for n, s in SHAPES.items():
        x = rng.normal(size=(k, *s)) * scale * np.exp(rng.uniform(-3, 3, size=(k, *s)))
        x = (x * (rng.random((k, *s)) < density)).astype(np.float32)
        if DTYPES[n] == BF:
            x = torch.from_numpy(x).to(BF).float().numpy()
        out[n] = x
    return out


def _mixed(tree):
    """A numpy tree -> the mixed layout's stacks (each leaf in its dtype)."""
    return MIXED.flatten({n: torch.from_numpy(np.ascontiguousarray(x)).to(DTYPES[n])
                          for n, x in tree.items()})


def _flat(tree):
    return FLAT.flatten({n: torch.from_numpy(np.ascontiguousarray(x)) for n, x in tree.items()})


def _tree_order(stacks, layout=MIXED):
    """One stack per group -> one float32 ``[..., N]`` stack in tree order."""
    segs = [sub.segments(x) for sub, x in zip(layout.groups, stacks, strict=True)]
    return torch.cat([segs[g][p].float() for g, p in layout.where], dim=-1)


def _split(flat, layout=MIXED):
    """A tree-order ``[..., N]`` stack -> one stack per group (float32)."""
    segs = FLAT.segments(flat)
    return tuple(torch.cat([segs[i] for i in idx], dim=-1) for idx in layout.index)


def _bits(x):
    x = x.float() if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float32))
    return x.contiguous().view(torch.int32)


def _assert_bitwise(got, want):
    assert torch.equal(_bits(got), _bits(want))


def test_groups_keep_their_tree_places():
    assert isinstance(MIXED, GroupedLayout) and MIXED.dtypes == (BF, F32)
    assert MIXED.index == ((0, 2, 4), (1, 3, 5))
    assert [g.leaf_ids for g in MIXED.groups] == list(MIXED.index)
    for g, sub in enumerate(MIXED.groups):
        for p, leaf in enumerate(sub.leaf_ids):
            want = torch.arange(FLAT.offsets[leaf], FLAT.offsets[leaf + 1])
            assert torch.equal(sub.tree_index(p), want), (g, p)
            assert torch.equal(sub.tree_index(p), FLAT.tree_index(leaf))
    assert MIXED.where == ((0, 0), (1, 0), (0, 1), (1, 1), (0, 2), (1, 2))
    assert not MIXED.cut and MIXED.group is None


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "rates"])
def test_global_topk_masks_are_the_float32_trees(kind, dynamic):
    z = _flat(_tree(1, density=0.1 if kind == "zeros" else 1.0))
    if kind == "ties":
        z = torch.round(z * 4) / 4
    cfg = TComp(scheme="dgc", rate=0.15, per_tensor=False)
    sel = tstages.get_stage("selector", "topk")
    rates = torch.tensor([0.05, 0.15, 0.6]) if dynamic else None
    groups = tuple(x.to(d) for x, d in zip(_split(z), MIXED.dtypes, strict=True))
    got = sel.select(cfg, groups, 0, MIXED, rates=rates)
    want = sel.select(cfg, z, 0, FLAT, rates=rates)
    assert all(m.dtype == F32 for m in got)
    _assert_bitwise(_tree_order(got), want)
    if not dynamic:  # at least the keep count (more where values tie the threshold)
        assert (want.sum(1) >= tsp.num_keep(FLAT.total, 0.15)).all()


def test_global_topk_downlink_is_the_float32_trees():
    cfg = TComp(scheme="dgcwgmf_dl", rate=0.2, downlink_rate=0.1, per_tensor=False)
    dl = tstages.get_stage("downlink", "topk")
    wire = tstages.get_stage("wire", "float32")
    # the residual's bfloat16 values are those of a bfloat16 sum: r + b is exact
    b = _flat(_tree(2, k=1))[0]
    b[::5] = 0.0
    r = torch.zeros_like(b)
    r[1::3] = b[1::3]
    cast = lambda x: tuple(p.to(d) for p, d in zip(_split(x), MIXED.dtypes, strict=True))
    out, res, nnz = dl.apply(cfg, wire, cast(r), cast(b), None, MIXED)
    w_out, w_res, w_nnz = dl.apply(cfg, wire, r, b, None, FLAT)
    _assert_bitwise(_tree_order(out), w_out)
    _assert_bitwise(_tree_order(res), w_res)
    assert int(nnz) == int(w_nnz) > 0


def test_randomk_uniforms_and_masks_are_the_float32_trees():
    cfg = TComp(scheme="randomk", rate=0.3)
    sel = tstages.get_stage("selector", "randomk")
    for t in (0, 5):
        u = [sel.uniforms(cfg, t, sub) for sub in MIXED.groups]
        _assert_bitwise(_tree_order([x[None] for x in u])[0], sel.uniforms(cfg, t, FLAT))
        v = _flat(_tree(4))
        masks = [sel.select(cfg, x, t, sub) for x, sub in zip(_split(v), MIXED.groups,
                                                               strict=True)]
        _assert_bitwise(_tree_order(masks), sel.select(cfg, v, t, FLAT))


def test_probquant_draws_and_round_trip_are_the_float32_trees():
    cfg = TComp(scheme="dgc", wire_dtype="probquant")
    wire = tstages.get_stage("wire", "probquant")
    ids = torch.tensor([2, 7, 11])
    x = _flat(_tree(5, scale=0.1))
    for ctx_cfg, ctx in ((None, None), (cfg, None),
                         (cfg, StageCtx(3, None, 1.0, 1.0, None, None, ids))):
        u = [wire.uniforms(ctx_cfg, sub, ctx) for sub in MIXED.groups]
        u = _tree_order([x if x.dim() == 2 else x[None] for x in u])
        want = wire.uniforms(ctx_cfg, FLAT, ctx)
        _assert_bitwise(u, want if want.dim() == 2 else want[None])
    ctx = StageCtx(3, None, 1.0, 1.0, None, None, ids)
    got = [wire.roundtrip_ctx(cfg, p, sub, ctx) for p, sub in zip(_split(x), MIXED.groups,
                                                                    strict=True)]
    _assert_bitwise(_tree_order(got), wire.roundtrip_ctx(cfg, x, FLAT, ctx))


@pytest.mark.parametrize("by_leaf", [False, True], ids=["plan", "by-leaf"])
def test_hadamard_diagonal_and_int8_round_trip_are_the_float32_trees(monkeypatch, by_leaf):
    cfg = TComp(scheme="dgc", rotation_stage="hadamard", wire_dtype="int8")
    rot = tstages.get_stage("rotation", "hadamard")
    scheme = resolve(cfg)
    if by_leaf:
        monkeypatch.setattr(type(rot), "PLAN_LIMIT", 0)
    d = [rot.diagonal(cfg, 2, sub) for sub in MIXED.groups]
    want = rot.diagonal(cfg, 2, FLAT)
    rotated = [rot.plan(sub)[0] for sub in MIXED.groups]
    flat_rot = rot.plan(FLAT)[0]
    segs = [r.segments(x) for r, x in zip(rotated, d, strict=True)]
    _assert_bitwise(torch.cat([segs[g][p] for g, p in MIXED.where]), want)
    assert sum(r.total for r in rotated) == flat_rot.total
    x = _flat(_tree(6, scale=1e-2))
    ctx = StageCtx(2, None, 1.0, 1.0, None, None)
    got = [scheme._encode_payload(cfg, p, TState(u={}, v=p.clone(), m={}), sub, None,
                                  ctx._replace(layout=sub))
           for p, sub in zip(_split(x), MIXED.groups, strict=True)]
    w_out, w_st = scheme._encode_payload(cfg, x, TState(u={}, v=x.clone(), m={}), FLAT, None,
                                         ctx._replace(layout=FLAT))
    _assert_bitwise(_tree_order([g[0] for g in got]), w_out)
    _assert_bitwise(_tree_order([g[1].v for g in got]), w_st.v)


def test_sketch_buckets_and_hitters_are_the_float32_trees():
    x = _flat(_tree(8, k=2))
    x[:, ::7] = 0.0
    groups = tuple(p.to(d) for p, d in zip(_split(x), MIXED.dtypes, strict=True))
    assert ts.by_pieces(MIXED, 5)
    # every leaf once, in tree order, with its whole-tree indices
    order = [(sub.leaf_ids[i], seg.shape[-1]) for sub, i, seg in ts._leaves(MIXED, groups)]
    assert order == [(j, FLAT.sizes[j]) for j in range(FLAT.num_leaves)]
    for rows, cols in ((5, 64), (4, 16)):
        s = ts.sketch_pieces(groups, MIXED, rows, cols)
        _assert_bitwise(s, ts.sketch(x, rows, cols))
        for k in (1, 17, 90):
            got = ts.hitters_pieces(s[0], MIXED, k)
            assert [h.dtype for h in got] == [F32, F32]
            _assert_bitwise(_tree_order([h[None] for h in got])[0],
                            ts.heavy_hitters(s[0], FLAT.total, k)[2])


def test_fetchsgd_step_is_the_float32_trees():
    cfg = TComp(scheme="fetchsgd", sketch_rows=5, sketch_cols=32, sketch_k_frac=0.1)
    scheme = resolve(cfg)
    x = _flat(_tree(9, scale=0.1))
    groups = tuple(p.to(d) for p, d in zip(_split(x), MIXED.dtypes, strict=True))
    params = {n: torch.zeros(s, dtype=DTYPES[n]) for n, s in SHAPES.items()}
    (c_m, s_m), (c_f, s_f) = scheme.init_states(params), scheme.init_states(
        {n: p.float() for n, p in params.items()})
    G, _, info = scheme.client_compress(c_m, groups, None, 0, layout=MIXED)
    W, _, winfo = scheme.client_compress(c_f, x, None, 0, layout=FLAT)
    _assert_bitwise(G, W)
    assert info.upload_nnz.tolist() == winfo.upload_nnz.tolist() == [5 * 32] * K
    for step in range(2):
        b, s_m, ai = scheme.server_aggregate(s_m, G.sum(0), K, layout=MIXED, lr=0.5)
        wb, s_f, wai = scheme.server_aggregate(s_f, W.sum(0), K, layout=FLAT, lr=0.5)
        assert [t.dtype for t in b] == [BF, F32]  # each group's hitters in its dtype
        want = _split(wb)
        for got, w, dt in zip(b, want, MIXED.dtypes, strict=True):
            _assert_bitwise(got, w.to(dt))
        for key in ("s_mom", "s_err"):
            _assert_bitwise(s_m.momentum[key], s_f.momentum[key])
        assert int(ai.download_nnz) == int(wai.download_nnz) == int(0.1 * FLAT.total)


def test_adaptive_keep_tables_are_the_float32_trees():
    rates = torch.tensor([0.013, 0.2, 0.91])
    got = [tsp.keep_table(sub, rates) for sub in MIXED.groups]  # [k, L_g] each
    got = torch.stack([got[g][:, p] for g, p in MIXED.where], dim=1)
    assert torch.equal(got, tsp.keep_table(FLAT, rates))


# ---------------------------------------------------------------------------
# against the JAX package, on the same mixed tree
# ---------------------------------------------------------------------------


def _row(tree, r):
    return {n: jnp.asarray(x[r], JNP[DTYPES[n]]) for n, x in tree.items()}


def _jorder(trees):
    """JAX trees (one per client) -> a float32 [k, N] stack in tree order."""
    return torch.from_numpy(np.stack([np.concatenate(
        [np.asarray(t[n], np.float32).reshape(-1) for n in NAMES]) for t in trees]))


def _torder(x):
    return _tree_order(x) if isinstance(x, tuple) else x.float()


def _check(G, st, info, want, fields):
    _assert_bitwise(_torder(G), _jorder([w[0] for w in want]))
    for f in fields:
        got = getattr(st, f)
        jl = [getattr(w[1], f) for w in want]
        # each group's state in the reference's leaf dtypes
        assert [x.dtype for x in got] == [
            {jnp.dtype(jnp.bfloat16): BF, jnp.dtype(jnp.float32): F32}[jl[0][NAMES[idx[0]]].dtype]
            for idx in MIXED.index], f
        _assert_bitwise(_torder(got), _jorder(jl))
    assert info.upload_nnz.tolist() == [int(w[2].upload_nnz) for w in want]


@pytest.mark.parametrize("scheme, kw, rates", [
    ("dgc", dict(per_tensor=False), None),
    ("dgcwgmf", dict(per_tensor=False, tau=0.6), None),
    ("dgc", dict(per_tensor=False), [0.05, 0.2, 0.45]),
    ("dgcwgmf", dict(tau=0.6), [0.05, 0.2, 0.45]),
], ids=["global-dgc", "global-dgcwgmf", "global-rates", "per-tensor-rates"])
def test_deterministic_stages_are_jax_bitwise(scheme, kw, rates):
    jcfg, tcfg = JComp(scheme=scheme, rate=0.15, **kw), TComp(scheme=scheme, rate=0.15, **kw)
    u, v, m = _tree(20, scale=1e-2), _tree(21, scale=1e-2), _tree(22, scale=1e-2)
    g, gbar = _tree(23, scale=1e-2), _tree(24, k=1, scale=1e-2)
    uses_m = resolve(tcfg).uses_m
    want = [jcompress(jcfg, JState(u=_row(u, r), v=_row(v, r), m=_row(m, r) if uses_m else {}),
                      _row(g, r), _row(gbar, 0), 1,
                      rate=None if rates is None else jnp.float32(rates[r]))
            for r in range(K)]
    G, st, info = tcompress(tcfg, TState(u=_mixed(u), v=_mixed(v), m=_mixed(m) if uses_m else {}),
                            _mixed(g), tuple(x[0] for x in _mixed(gbar)), 1,
                            rates=None if rates is None else torch.tensor(rates), layout=MIXED)
    _check(G, st, info, want, "uvm" if uses_m else "uv")


def _jax_draws(make, t):
    """Per leaf of the tree (tree order), JAX's draws ``make(key, leaf, n)``,
    served to the port's draw method per dtype group."""
    per_leaf = [np.asarray(make(i, n)).reshape(-1) for i, n in enumerate(NAMES)]

    def serve(layout):
        return torch.from_numpy(np.concatenate([per_leaf[i] for i in layout.leaf_ids], axis=-1))

    return serve


def test_randomk_twin_is_jax_bitwise(monkeypatch):
    sel = tstages.get_stage("selector", "randomk")
    jcfg, tcfg = JComp(scheme="randomk", rate=0.2), TComp(scheme="randomk", rate=0.2)
    v = _tree(30)
    for t in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(17), jnp.asarray(t, jnp.int32))
        serve = _jax_draws(lambda i, n, key=key: jax.random.uniform(
            jax.random.fold_in(key, i), SHAPES[n]), t)
        monkeypatch.setattr(sel, "uniforms", lambda cfg, r, layout, serve=serve: serve(layout))
        g = _tree(31 + t)
        want = [jcompress(jcfg, JState(u={}, v=_row(v, r), m={}), _row(g, r), _row(g, r), t)
                for r in range(K)]
        G, st, info = tcompress(tcfg, TState(u={}, v=_mixed(v), m={}), _mixed(g),
                                tuple(x[0] for x in _mixed(g)), t, layout=MIXED)
        _check(G, st, info, want, "v")
        v = {n: np.stack([np.asarray(w[1].v[n], np.float32) for w in want]) for n in NAMES}


def test_dgc_hadamard_int8_twin_is_jax_bitwise(monkeypatch):
    rot = tstages.get_stage("rotation", "hadamard")
    jrot = jstages.get_stage("rotation", "hadamard")
    kw = dict(scheme="dgc", rate=0.1, rotation_stage="hadamard", wire_dtype="int8")
    jcfg, tcfg = JComp(**kw), TComp(**kw)
    u, v, g = _tree(40, scale=1e-2), _tree(41, scale=1e-2), _tree(42, scale=1e-2)
    t = 1
    serve = _jax_draws(lambda i, n: jrot._diag(jcfg, jrot._padded(int(np.prod(SHAPES[n]))),
                                               jnp.asarray(t), i), t)
    monkeypatch.setattr(rot, "diagonal", lambda cfg, r, layout: serve(layout))
    want = [jcompress(jcfg, JState(u=_row(u, r), v=_row(v, r), m={}), _row(g, r), _row(g, r), t)
            for r in range(K)]
    G, st, info = tcompress(tcfg, TState(u=_mixed(u), v=_mixed(v), m={}), _mixed(g),
                            tuple(x[0] for x in _mixed(g)), t, layout=MIXED)
    _check(G, st, info, want, "uv")
    assert info.upload_nnz.tolist() == [sum(rot.wire_size(n) for n in FLAT.sizes)] * K


def test_dgc_probquant_twin_is_jax_bitwise(monkeypatch):
    wire = tstages.get_stage("wire", "probquant")
    kw = dict(scheme="dgc", rate=0.2, wire_dtype="probquant")
    jcfg, tcfg = JComp(**kw), TComp(**kw)
    clients, t = [2, 5, 9], 1
    per_client = []
    for c in clients:
        def make(i, n, c=c):
            size = int(np.prod(SHAPES[n]))
            key = jax.random.fold_in(jax.random.PRNGKey(tcfg.probquant_seed),
                                     jnp.asarray(t, jnp.int32))
            key = jax.random.fold_in(jax.random.fold_in(key, i), jnp.asarray(c, jnp.int32))
            return np.asarray(jax.random.uniform(key, (-(-size // 256), 256))).reshape(-1)[:size]
        per_client.append(_jax_draws(make, t))
    monkeypatch.setattr(wire, "uniforms", lambda cfg, layout, ctx: torch.stack(
        [serve(layout) for serve in per_client]))
    u, v, g = _tree(50, scale=1e-2), _tree(51, scale=1e-2), _tree(52, scale=1e-2)
    want = [jcompress(jcfg, JState(u=_row(u, r), v=_row(v, r), m={}), _row(g, r), _row(g, r), t,
                      client_id=jnp.asarray(c)) for r, c in enumerate(clients)]
    G, st, info = tcompress(tcfg, TState(u=_mixed(u), v=_mixed(v), m={}), _mixed(g),
                            tuple(x[0] for x in _mixed(g)), t, client_ids=torch.tensor(clients),
                            layout=MIXED)
    _check(G, st, info, want, "uv")


def test_fetchsgd_client_and_server_are_jax_bitwise():
    kw = dict(scheme="fetchsgd", sketch_rows=5, sketch_cols=32, sketch_k_frac=0.1)
    jcfg, tcfg = JComp(**kw), TComp(**kw)
    js, ts_ = jresolve(jcfg), resolve(tcfg)
    g = _tree(60, scale=0.1)
    params = {n: jnp.zeros(s, JNP[DTYPES[n]]) for n, s in SHAPES.items()}
    jc, jsrv = js.init_states(params)
    tc, tsrv = ts_.init_states(from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                               layout="transformer"))
    want = [jcompress(jcfg, jc, _row(g, r), _row(g, r), 0) for r in range(K)]
    G, _, info = tcompress(tcfg, tc, _mixed(g), None, 0, layout=MIXED)
    _assert_bitwise(G, torch.from_numpy(np.stack([np.asarray(w[0]["sketch"]).reshape(-1)
                                                  for w in want])))
    jsum = jax.tree_util.tree_map(lambda *x: sum(x), *[w[0] for w in want])
    jb, jsrv2, jai = js.server_aggregate(jsrv, jsum, K, lr=0.5, params=params)
    tb, tsrv2, tai = ts_.server_aggregate(tsrv, G.sum(0), K, layout=MIXED, lr=0.5)
    # the port's hitters in each group's dtype (the reference's stay float32
    # until its update casts them to the leaf's)
    _assert_bitwise(_tree_order(tb), _jorder([{n: jnp.asarray(x).astype(JNP[DTYPES[n]])
                                                 for n, x in jb.items()}]).reshape(-1))
    for key in ("s_mom", "s_err"):
        _assert_bitwise(tsrv2.momentum[key], jsrv2.momentum[key])
    assert int(tai.download_nnz) == int(jai.download_nnz)
    assert isinstance(tsrv2, ServerState) and isinstance(jsrv2, JServer)


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_radix_select_over_groups_is_topk(kind):
    """``group_kth_largest`` over a sequence of key stacks (the dtype groups'
    of a tree cut over ranks): the k-th largest of their concatenation,
    bitwise ``torch.topk``'s."""
    z = _flat(_tree(70)).abs()
    if kind == "ties":
        z = torch.round(z * 8) / 8
    parts = _split(z)
    for ks in ([1, 1, 1], [5, 77, 431], [431, 200, 2]):
        k = torch.tensor(ks)
        got = tsp.group_kth_largest([p.contiguous().view(torch.int32) for p in parts], k,
                                    31).to(torch.int32).view(torch.float32)
        want = torch.stack([torch.topk(z[r], ks[r]).values[-1] for r in range(K)])
        assert torch.equal(got, want), ks
