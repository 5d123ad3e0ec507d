"""K1's selection on the flat state: the plain per-segment versions of
``gmf_select`` (norms and exact top-k thresholds) and of its ``|z|`` mode
against the JAX package leaf by leaf, the fused GMF path on flat state
against the JAX fused path, and an emulation of the kernel's radix select
against ``torch.topk``.

* Thresholds and masks are bitwise: the k-th largest value of a multiset
  does not depend on the algorithm that finds it, so on the same z
  ``torch.topk`` per segment and JAX's ``exact_threshold`` per leaf agree
  exactly. Norms are sums taken in another order: within 1e-6 relative.
* The fused path is held at ``tests/test_torch_schemes.py``'s tolerances
  (rtol 1e-5 / atol 1e-6, nnz exact, a mask flip only within 1e-5 of its
  threshold), fused against fused.
* The radix emulation does what ``csrc/gmf_compress.cu``'s ``select_kernel``
  does, on whole tensors: three passes of 11, 11 and 10 bits over the
  scores' float bits, a 2,048-bin count of the candidates that match the
  digits found so far, and the bin that holds the k-th largest counted from
  the top. It must give ``torch.topk(z, k).values[-1]`` bit for bit,
  ties, zeros and single elements included. The tiled emulation does it as
  the kernel does for a leaf split over ``plan_select``'s tiles: per-tile
  counts summed into the segment's histogram and the kernel's own scan
  from the top bin; and the norms from the tiles' float64 partials summed
  in tile order, within 1e-6 of ``fusion.segment_norms`` and bitwise on a
  second run.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import schemes as js
from repro.core import sparsify as jsp
from repro.core import stages as jstages
from repro_torch.core import schemes as ts
from repro_torch.core import sparsify as tsp
from repro_torch.core import stages as tstages
from repro_torch.kernels import ref
from repro_torch.utils.flat import FlatLayout

SHAPES = {"a": (1,), "b": (3,), "c": (10,), "d": (16,), "e": (3, 3, 8, 16), "f": (33, 7)}
LAYOUT = FlatLayout.of({k: torch.zeros(s) for k, s in SHAPES.items()})
K = 3


def _stacks(seed, ties=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = rng.normal(size=(K, LAYOUT.total)).astype(np.float32)
        if ties:
            x = (np.round(x * 4) / 4).astype(np.float32)
        out.append(torch.from_numpy(x))
    return out


def _jleaf(x, i):
    """Leaf i of client row x of a flat stack, as a JAX array."""
    o, n = LAYOUT.offsets[i], LAYOUT.sizes[i]
    return jnp.asarray(x[o:o + n].numpy().reshape(LAYOUT.shapes[i]))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("tau", [0.0, 0.3, 1.0])
def test_gmf_select_thresholds_bitwise_jax_per_leaf(tau, ties):
    _, v, m = _stacks(0, ties)
    v[1, LAYOUT.offsets[2]:LAYOUT.offsets[3]] = 0.0  # an all-zero segment
    m[2, LAYOUT.offsets[3]:LAYOUT.offsets[4]] = 0.5  # an all-equal one
    w = torch.tensor([1.0, 0.5, 2.0])
    tau_k = torch.full((K,), tau)
    inv_nv, inv_nm, thr = ref.gmf_select(v, m, LAYOUT, 0.1, w=w, tau=tau_k, eps=1e-16)
    assert inv_nv.shape == inv_nm.shape == thr.shape == (K, LAYOUT.num_leaves)
    z = ref.gmf_fusion_score(v, m, inv_norm_v=LAYOUT.expand(inv_nv),
                             inv_norm_m=LAYOUT.expand(inv_nm), tau=tau_k)
    for r in range(K):
        for i in range(LAYOUT.num_leaves):
            jv, jm = _jleaf(v[r], i), _jleaf(m[r], i)
            want_nv = float(w[r]) / (float(jnp.sqrt(jnp.sum(jnp.square(jv)))) + 1e-16)
            want_nm = 1.0 / (float(jnp.sqrt(jnp.sum(jnp.square(jm)))) + 1e-16)
            np.testing.assert_allclose(float(inv_nv[r, i]), want_nv, rtol=1e-6, atol=0)
            np.testing.assert_allclose(float(inv_nm[r, i]), want_nm, rtol=1e-6, atol=0)
            jz = _jleaf(z[r], i).reshape(-1)
            want = jsp.exact_threshold(jz, jsp.num_keep(jz.shape[0], 0.1))
            assert float(thr[r, i]) == float(want), (r, i)


@pytest.mark.parametrize("ties", [False, True])
def test_topk_abs_select_bitwise_jax_per_leaf(ties):
    z, _, _ = _stacks(1, ties)
    z[0, LAYOUT.offsets[4]:LAYOUT.offsets[5]] = 0.0
    thr, mask = tsp.segment_topk_mask(z, LAYOUT, 0.1)
    for r in range(K):
        for i in range(LAYOUT.num_leaves):
            jz = _jleaf(z[r], i)
            want = jsp.topk_mask(jz, 0.1, "exact")
            assert np.array_equal(_jleaf(mask[r], i), np.asarray(want)), (r, i)
            ja = jnp.abs(jz).reshape(-1)
            assert float(thr[r, i]) == float(jsp.exact_threshold(ja, jsp.num_keep(ja.shape[0],
                                                                                    0.1)))


@pytest.mark.parametrize("selector", ["exact", "sampled"])
@pytest.mark.parametrize("tau", [0.3, 1.0])
def test_fused_path_on_flat_state_matches_jax_fused(tau, selector):
    """``fused_compress`` on the flat ``[K, N]`` stacks against the JAX
    package's fused path (``repro.core.stages.GlobalMomentumFusion
    .fused_compress``), one client at a time, eagerly (its Pallas kernel
    interpreted)."""
    kw = dict(scheme="dgcwgmf", rate=0.1, tau=tau, use_kernels=True, selector=selector)
    jcfg, tcfg = js.CompressionConfig(**kw), ts.CompressionConfig(**kw)
    jscheme, tscheme = js.resolve(jcfg), ts.resolve(tcfg)
    u, v, m = _stacks(2)
    gbar = torch.from_numpy(np.random.default_rng(3).normal(size=LAYOUT.total)
                            .astype(np.float32))
    ctx = tstages.StageCtx(round_idx=1, gbar_prev=gbar, local_steps=1.0, mean_steps=1.0,
                           tau_override=None, layout=LAYOUT)
    g, u2, v2, m2, masks = tscheme.fusion.fused_compress(tcfg, u, v, m, ctx)
    # the port's scores and thresholds, for the boundary check of a flip
    tau_k, w = torch.full((K,), tau), torch.ones(K)
    inv_nv, inv_nm, thr = ref.gmf_select(v, m2, LAYOUT, 0.1, w=w, tau=tau_k, eps=1e-16)
    if selector == "sampled":
        thr = tscheme.fusion._sampled_thresholds(tcfg, v, m2, inv_nv, inv_nm, tau_k, LAYOUT)
    z = ref.gmf_fusion_score(v, m2, inv_norm_v=LAYOUT.expand(inv_nv),
                             inv_norm_m=LAYOUT.expand(inv_nm), tau=tau_k)
    tree = lambda x: {k: _jleaf(x, i) for i, k in enumerate(sorted(SHAPES))}
    jctx = jstages.StageCtx(round_idx=1, gbar_prev=tree(gbar), local_steps=1.0,
                            mean_steps=1.0, tau_override=None)
    for r in range(K):
        jg, ju, jv, jm, jmask = jscheme.fusion.fused_compress(jcfg, tree(u[r]), tree(v[r]),
                                                              tree(m[r]), jctx)
        assert int(masks[r].sum()) == sum(int(jnp.sum(x)) for x in
                                          jax.tree_util.tree_leaves(jmask))
        for i, k in enumerate(sorted(SHAPES)):
            flip = np.asarray(_jleaf(masks[r], i)) != np.asarray(jmask[k])
            if flip.any():
                rel = np.abs(np.asarray(_jleaf(z[r], i)) - float(thr[r, i])) / float(thr[r, i])
                assert (rel[flip] <= 1e-5).all(), f"mask flip off the boundary: {rel[flip]}"
            for got, want in ((g, jg), (u2, ju), (v2, jv), (m2, jm)):
                a, b = np.asarray(_jleaf(got[r], i)), np.asarray(want[k])
                if got is not m2:
                    a, b = a[~flip], b[~flip]
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the kernel's radix select, emulated
# ---------------------------------------------------------------------------


def radix_kth_largest(z: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest of the non-negative float32 scores z as
    ``select_kernel`` finds it: digits of 11, 11 and 10 bits from the top,
    each pass counting the candidates whose higher digits match the ones
    found, and taking the bin where the count from the top reaches k."""
    bits = z.reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    prefix, pmask, rank = 0, 0, k
    for shift, width in ((21, 11), (10, 11), (0, 10)):
        dmask = (1 << width) - 1
        cand = bits[(bits & pmask) == prefix]
        hist = torch.bincount((cand >> shift) & dmask, minlength=2048)
        from_top = torch.cumsum(hist.flip(0), 0).flip(0)  # count in bins >= b
        b = int(torch.nonzero(from_top >= rank).max())
        rank -= int(from_top[b + 1]) if b + 1 < 2048 else 0
        prefix |= b << shift
        pmask |= dmask << shift
    return torch.tensor([prefix], dtype=torch.int64).to(torch.int32).view(torch.float32)[0]


def _scores(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return torch.zeros(n)
    if kind == "equal":
        return torch.full((n,), 0.75)
    x = np.abs(rng.normal(size=n)).astype(np.float32)
    if kind == "ties":
        x = (np.round(x * 8) / 8).astype(np.float32)
    if kind == "tiny":  # subnormals and zeros beside normal values
        x = x * np.float32(1e-39) * (rng.random(n) > 0.3)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "equal", "tiny"])
@pytest.mark.parametrize("n", [1, 3, 10, 16, 36_864])
def test_radix_select_emulation_matches_topk(n, kind):
    z = _scores(n, kind, seed=n)
    for k in sorted({1, max(1, math.ceil(0.1 * n)), (n + 1) // 2, n}):
        got = radix_kth_largest(z, k)
        want = torch.topk(z, k).values[-1]
        assert got.view(torch.int32) == want.view(torch.int32), (n, kind, k)


def scan_from_top(hist: torch.Tensor, rank: int) -> tuple[int, int]:
    """``scan_bins`` of ``csrc/gmf_compress.cu``: 256 threads own 8 bins
    each from the top (thread t bins 2047 - 8t down to 2040 - 8t), an
    inclusive scan of their counts in thread order, and the thread whose
    range holds ``rank`` walks its bins -> (digit, rank inside its bin); a
    rank past every count finds (0, 0)."""
    c = hist.flip(0).reshape(256, 8).tolist()
    above = 0
    for t, bins in enumerate(c):
        own = sum(bins)
        if above < rank <= above + own:
            acc = above
            for j, n in enumerate(bins):
                if acc + n >= rank:
                    return 2047 - 8 * t - j, rank - acc
                acc += n
        above += own
    return 0, 0


def tiled_kth_largest(z: torch.Tensor, k: int, tile: int) -> torch.Tensor:
    """The k-th largest of the non-negative float32 scores z of one leaf as
    ``select_kernel`` finds it when the leaf is split over the tiles of
    ``plan_select``: in each of the three passes every tile counts its own
    candidates in a 2,048-bin histogram, the tiles' counts are added into
    the segment's histogram (integers: the order does not matter), and the
    last tile's scan takes the digit and the rank inside its bin."""
    from repro_torch.kernels import gmf_compress as gk

    plan = gk.plan_select([z.numel()], tile)
    bits = z.reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    prefix, pmask, rank = 0, 0, k
    for shift, width in ((21, 11), (10, 11), (0, 10)):
        dmask = (1 << width) - 1
        hist = torch.zeros(2048, dtype=torch.int64)
        for _, start, length in plan.blocks.tolist():
            part = bits[start:start + length]
            cand = part[(part & pmask) == prefix]
            hist += torch.bincount((cand >> shift) & dmask, minlength=2048)
        digit, rank = scan_from_top(hist, rank)
        prefix |= digit << shift
        pmask |= dmask << shift
    return torch.tensor([prefix], dtype=torch.int64).to(torch.int32).view(torch.float32)[0]


@pytest.mark.parametrize("tiles, tile", [("1", 36_864), ("2", 18_432), ("many", 1000)])
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "equal", "tiny"])
def test_tiled_radix_select_emulation_matches_topk(kind, tiles, tile):
    """A 36,864-element leaf (ResNet-56's largest) whole, in two tiles and
    in 37: ties, zeros and equal values straddle the tiles' borders."""
    n = 36_864
    z = _scores(n, kind, seed=7)
    for k in sorted({1, math.ceil(0.1 * n), n // 2, n}):
        got = tiled_kth_largest(z, k, tile)
        want = torch.topk(z, k).values[-1]
        assert got.view(torch.int32) == want.view(torch.int32), (kind, tiles, k)


def test_tiled_radix_select_ties_across_tile_borders():
    """The k-th largest value is one tied value whose copies lie in several
    tiles on both sides of their borders, with k inside the run of ties."""
    n, tile = 5 * 1000 + 3, 1000
    z = torch.from_numpy((np.random.default_rng(9).random(n) * 0.5).astype(np.float32))
    for lo, hi in ((900, 1100), (2950, 3050), (4990, 5003)):
        z[lo:hi] = 0.75
    for k in (1, 150, 200, 313, 314, 400):
        got = tiled_kth_largest(z, k, tile)
        assert got.view(torch.int32) == torch.topk(z, k).values[-1].view(torch.int32), k


def tile_norms(x: torch.Tensor, layout, tile: int) -> torch.Tensor:
    """Every (row, leaf) segment's L2 norm as the kernel forms it over the
    leaf's tiles: each tile's float32 squares summed in float64 (the tile's
    own partial), the partials summed in tile order, the square root of the
    float32-rounded sum -> ``[rows, L]`` float32."""
    from repro_torch.kernels import gmf_compress as gk

    plan = gk.plan_select(layout.sizes, tile)
    x = x.numpy()
    out = np.zeros((x.shape[0], layout.num_leaves), np.float32)
    for r in range(x.shape[0]):
        for i, o in enumerate(layout.offsets[:-1]):
            total = 0.0
            for _, start, length in plan.blocks[plan.first[i]:plan.first[i + 1]].tolist():
                seg = x[r, o + start:o + start + length]
                total += float(np.sum((seg * seg).astype(np.float64)))
            out[r, i] = np.sqrt(np.float32(total))
    return torch.from_numpy(out)


@pytest.mark.parametrize("tile", [1000, 4096, 36_864])
def test_tiled_norms_match_segment_norms_and_repeat_bitwise(tile):
    """The tiles' float64 partials, summed in a fixed (tile) order, give the
    norms within 1e-6 relative of ``fusion.segment_norms``; and that order
    is the leaf cut at every multiple of the tile from its start, first
    tile first, bit for bit, which is what ``plan_select``'s first-tile
    prefix hands the kernel's last tile to add. The kernel's own two runs
    are held bitwise equal on the card (``chip_smoke.py``)."""
    from repro_torch.core import fusion

    layout = FlatLayout.of_sizes([36_864, 5003, 3, 0, 1000], "cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, layout.total))
                         .astype(np.float32))
    got = tile_norms(x, layout, tile)
    want = fusion.segment_norms(x, layout)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)
    ordered = np.zeros_like(got.numpy())
    for r, row in enumerate(x.numpy()):
        for i, (o, n) in enumerate(zip(layout.offsets[:-1], layout.sizes, strict=True)):
            total = 0.0
            for part in np.split(row[o:o + n], range(tile, n, tile)):
                total += float(np.sum((part * part).astype(np.float64)))
            ordered[r, i] = np.sqrt(np.float32(total))
    np.testing.assert_array_equal(got.numpy().view(np.int32), ordered.view(np.int32))


# ---------------------------------------------------------------------------
# the card path's launches, with the kernels stood in for by their plain
# versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme, want", [
    ("dgcwgmf", {"gmf_select": 1, "gmf_compress": 1, "momentum_correction": 1}),
    ("dgc", {"gmf_select": 1, "apply_mask": 1, "momentum_correction": 1}),
])
def test_card_path_is_one_call_per_kernel_and_no_loop_over_leaves(monkeypatch, scheme, want):
    """``client_compress`` as it runs on the card (``kernels.ops`` taking
    every tensor for a CUDA one), over ResNet-20's 61 leaves: each kernel
    wrapper is called once, and nothing outside the kernels walks the
    layout's segments, the plain versions' per-leaf loop. The stand-ins
    compute what the kernels do with the plain versions."""
    from repro_torch.kernels import gmf_compress as gk
    from repro_torch.kernels import ops
    from repro_torch.models import resnet

    params = resnet.init_resnet(torch.Generator().manual_seed(0), depth=20)
    layout = FlatLayout.of(params)
    calls = {}
    walks = {"outside": 0, "inside": False}
    segments = FlatLayout.segments

    def count_walks(self, flat):
        walks["outside"] += not walks["inside"]
        return segments(self, flat)

    def kernel(name, plain):
        def run(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            walks["inside"] = True
            try:
                return plain(*args, **kw)
            finally:
                walks["inside"] = False
        return run

    def rate_of(keep):
        return next(r for r, (_, d) in layout._keep.items() if d is keep)

    monkeypatch.setattr(FlatLayout, "segments", count_walks)
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    monkeypatch.setattr(gk, "gmf_select_flat", kernel(
        "gmf_select", lambda v, m, *, offsets, plan, keep, group, **kw:
        ref.gmf_select(v, m, layout, rate_of(keep), **kw)))
    monkeypatch.setattr(gk, "topk_abs_select_flat", kernel(
        "gmf_select", lambda z, *, offsets, plan, keep, group: tsp.segment_topk_mask(
            z, layout, rate_of(keep))))
    monkeypatch.setattr(gk, "gmf_compress_flat", kernel(
        "gmf_compress", lambda u, v, m, *, offsets, **kw:
        ref.gmf_compress_segments(u, v, m, layout=layout, **kw)))
    monkeypatch.setattr(gk, "apply_mask_flat", kernel("apply_mask", ref.apply_mask_update_leaf))
    monkeypatch.setattr(gk, "momentum_correction_tree", kernel(
        "momentum_correction", lambda us, vs, gs, a: tuple(
            map(list, zip(*(ref.momentum_correction_leaf(*x, a) for x in zip(us, vs, gs)))))))
    cfg = ts.CompressionConfig(scheme=scheme, rate=0.1, tau=0.6, use_kernels=True)
    state, _ = ts.init_states(cfg, params)
    rng = np.random.default_rng(5)
    state = type(state)(*(f.expand(4, -1).clone() if torch.is_tensor(f) else f for f in state))
    grad = torch.from_numpy(rng.normal(size=(4, layout.total)).astype(np.float32))
    gbar = torch.from_numpy(rng.normal(size=layout.total).astype(np.float32))
    g, _, info = ts.client_compress(cfg, state, grad, gbar, 2, layout=layout)
    assert calls == want
    assert walks["outside"] == 0
    assert g.shape == (4, layout.total)
    assert info.upload_nnz.tolist() == [sum(layout.keep(0.1)[0])] * 4


@pytest.mark.parametrize("wrapper", ["gmf_select_flat", "topk_abs_select_flat",
                                     "gmf_compress_flat"])
def test_select_and_mask_pass_wrappers_refuse_cpu_tensors(wrapper):
    """The CUDA wrappers launch or raise: a CPU tensor never takes the plain
    version there (``kernels.ops`` sends CPU tensors to ``kernels.ref``)."""
    from repro_torch.kernels import gmf_compress as gk

    x, k = torch.zeros(K, LAYOUT.total), torch.zeros(K)
    s = torch.zeros(K, LAYOUT.num_leaves)
    call = {
        "gmf_select_flat": lambda: gk.gmf_select_flat(
            x, x, offsets=LAYOUT.offsets_dev, plan=LAYOUT.select_plan(), keep=LAYOUT.keep(0.1)[1],
            w=k, tau=k, eps=1e-16),
        "topk_abs_select_flat": lambda: gk.topk_abs_select_flat(
            x, offsets=LAYOUT.offsets_dev, plan=LAYOUT.select_plan(), keep=LAYOUT.keep(0.1)[1]),
        "gmf_compress_flat": lambda: gk.gmf_compress_flat(
            x, x, x, offsets=LAYOUT.offsets_dev, inv_norm_v=s, inv_norm_m=s, tau=k,
            threshold=s),
    }[wrapper]
    with pytest.raises(ValueError, match="cuda"):
        call()
