"""Tensor parallelism over the mesh's ``model`` axis (ROADMAP item 11 part
C1): the port over a two-rank gloo world at (data 1, model 2) against the
JAX package's one-device run and the port's own one-rank run on the same
inputs, and ``gmf_select``'s group mode. The four-rank cases against JAX
are in ``tests/test_torch_dist_step.py``.

Two ranks, spawned once for the module (``tests/torch_tp_ranks.py``, one
CPU thread a rank), while this process runs the JAX side:
- the families the four-rank JAX cases leave out (mamba2, recurrentgemma,
  musicgen-large, qwen2-vl, qwen2.5-3b at smoke size), on the same params
  (numpy leaves) and numpy-seeded batches in both packages: the loss, every
  gradient (the rank's pieces against the same pieces of the whole
  gradient), one prefill and 4 greedy decode steps, each within 1e-5
  (relative to the largest magnitude, or relative L2 for logits) of JAX's
  one-device run on the same inputs (JAX computes the unsharded function
  at any mesh), the tokens equal; the port's one-rank run is held to the
  same as a second witness;
- the plain group select (norms summed over the group, the cut segments'
  scores all-gathered before ``torch.topk``) against the one-rank select on
  the whole leaves: keep counts from the whole sizes, thresholds and norms
  bitwise (integer-valued v and m, whose sums of squares are exact in any
  order), masks and counts equal, in both modes, with ties spanning both
  ranks; the fused dgcwgmf compression's payload and counts through
  ``Scheme.client_compress``;
- a dense step with the optimiser's global-norm clip, momentum and weight
  decay: the whole params within 1e-5;
- the continuous-batching engine at (1, 2) (ROADMAP item 11 part C2a), each
  rank its pieces of the params and of the paged pool, with the float32
  and the int8 codecs, on llama's smoke (its 2 kv heads one a rank) and
  yi-34b's (one kv head: the pool whole, the projections gathered): every
  request's tokens equal to the one-rank engine's.

- every compression stage over leaves cut across the model axis (ROADMAP
  item 11 part C2b): each composition (``ranks.STAGE_CASES``: the ones
  that acted elementwise or per leaf before, the sampled estimator, global
  top-k, random-k, FetchSGD, the int8 and probquant wires, the Hadamard
  rotation, adaptive rates with per-client rates and wire levels, the
  top-k downlink's variants) through ``client_compress`` and
  ``server_aggregate`` on the rank's pieces (the layout ``over`` the group
  with each piece's box) against the one-rank run on the whole leaves:
  payloads, U/V/M, broadcasts, residuals, server momentum and every count
  bitwise, but the sketch, whose buckets sum in another order over the
  ranks (within SKETCH_REL of its largest magnitude; 2.9e-7 measured), its
  hitters bitwise on the same summed sketch (and on a tie-heavy sketch,
  ties spanning both ranks, to the lower whole index); and the piece-local version
  (the pieces taken for whole leaves: local indices, blocks, samples and
  top-k) differs on the same inputs.

In process: a CPU emulation of the group mode (each rank's sample and
bracket, pass 0's counts and kept candidates, the ranks' histograms summed,
the kernel's scan from the top, each tile's choice between its candidates
and a full read in passes 1 and 2) gives the whole leaf's k-th largest bit
for bit, with pieces built to miss the bracket, overflow the candidate
slots, or miss on one rank alone; the group plan puts the cut segments
first.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import test_torch_select as sel  # noqa: E402
import torch_tp_ranks as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.dist import step as jstep  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import CompressionConfig, resolve  # noqa: E402
from repro_torch.kernels import gmf_compress as gk  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

REL = 1e-5
SKETCH_REL = 1e-5  # the sketch over two ranks, of its largest magnitude


def jax_inputs():
    """Each arch's params (the port's init from seed 0, as numpy leaves, as
    the four-rank cases make them) and batch."""
    inp = {}
    for arch in ranks.ARCHS:
        cfg = tconfigs.get_smoke(arch)
        whole = ttr.init_params(cfg, torch.Generator().manual_seed(0))
        for i, x in enumerate(tree_leaves(whole)):
            inp[f"{arch}/param/{i}"] = x.numpy()
        for k, x in ranks.batch_of(cfg, 1).items():
            inp[f"{arch}/batch/{k}"] = x
    return inp


def jax_side(inp):
    """JAX's one-device loss, gradients, prefill and greedy decode of each
    arch on ``inp``, under the ranks' keys with the tag ``jax``."""
    out = {}
    for arch in ranks.ARCHS:
        cfg = jconfigs.get_smoke(arch)
        like = jax.eval_shape(lambda cfg=cfg: jtr.init_params(cfg, jax.random.PRNGKey(0)))
        n = len(jax.tree_util.tree_leaves(like))
        jp = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like),
                                          [jnp.asarray(inp[f"{arch}/param/{i}"]) for i in range(n)])
        batch = {k[len(arch) + 7:]: jnp.asarray(v) for k, v in inp.items()
                 if k.startswith(f"{arch}/batch/")}
        (loss, _), grads = jax.jit(jax.value_and_grad(jstep.make_loss_fn(cfg), has_aux=True))(
            jp, batch)
        out[f"{arch}/jax/loss"] = np.asarray(loss)
        for i, g in enumerate(jax.tree_util.tree_leaves(grads)):
            out[f"{arch}/jax/grad/{i}"] = np.asarray(g)
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        logits, cache = jax.jit(jstep.make_prefill_step(
            cfg, cache_len=ranks.SEQ + ranks.DECODE))(jp, prompt)
        out[f"{arch}/jax/prefill"] = np.asarray(logits)
        serve = jax.jit(jstep.make_serve_step(cfg))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        for t in range(ranks.DECODE):
            tok, logits, cache = serve(jp, cache, tok,
                                       jnp.asarray(ranks.decode_pos(cfg) + t, jnp.int32))
            out[f"{arch}/jax/decode/{t}"] = np.asarray(logits)
            out[f"{arch}/jax/token/{t}"] = np.asarray(tok)
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The two ranks' results, each with JAX's (run here while they run)."""
    workdir = tmp_path_factory.mktemp("tp2")
    inp = jax_inputs()
    procs = ranks.spawn(workdir, inp)
    try:
        want = jax_side(inp)
    finally:
        res = ranks.results(workdir, procs)
    return [dict(r, **want) for r in res]


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def cut_like(whole, piece, r):
    """Rank ``r``'s piece of the whole array ``whole``, cut along the one
    dim where the shapes differ (``piece``'s shape says which)."""
    dims = [d for d, (a, b) in enumerate(zip(whole.shape, piece.shape, strict=True)) if a != b]
    if not dims:
        return whole
    (d,) = dims
    return np.split(whole, whole.shape[d] // piece.shape[d], axis=d)[r]


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_two_ranks_match_one_rank(world2, arch):
    """The mesh run against JAX's one-device run and the port's one-rank run."""
    for r, res in enumerate(world2):
        assert res[f"{arch}/cut"].any(), (arch, "no leaf cut over the model axis")
        n = len([k for k in res if k.startswith(f"{arch}/one/grad/")])
        assert n == len(res[f"{arch}/cut"])
        assert n == len([k for k in res if k.startswith(f"{arch}/jax/grad/")])
        loss = float(res[f"{arch}/tp/loss"])
        for ref in ("jax", "one"):
            want = float(res[f"{arch}/{ref}/loss"])
            assert abs(loss - want) <= REL * abs(want), (arch, r, ref, loss, want)
            for i in range(n):
                got = res[f"{arch}/tp/grad/{i}"]
                err = max_rel(got, cut_like(res[f"{arch}/{ref}/grad/{i}"], got, r))
                assert err <= REL, (arch, r, ref, i, err)
            err = rel_l2(res[f"{arch}/tp/prefill"], res[f"{arch}/{ref}/prefill"])
            assert err <= REL, (arch, r, ref, err)
            for t in range(ranks.DECODE):
                err = rel_l2(res[f"{arch}/tp/decode/{t}"], res[f"{arch}/{ref}/decode/{t}"])
                assert err <= REL, (arch, r, ref, t, err)
                assert np.array_equal(res[f"{arch}/tp/token/{t}"], res[f"{arch}/{ref}/token/{t}"])


@pytest.mark.parametrize("rate", ranks.RATES)
def test_group_select_is_the_whole_leaves_select(world2, rate):
    for res in world2:
        assert res["select/cut"].tolist() == [v[1] is not None for v in ranks.SELECT.values()]
        keep = res[f"select/{rate}/keep"]
        assert keep[0].tolist() == keep[1].tolist()  # from the whole sizes
        assert keep[0].tolist() == [math.ceil(rate * math.prod(s)) for s, _ in
                                    ranks.SELECT.values()]
        for name in ("inv_nv", "inv_nm", "thr", "abs_thr"):
            got, want = res[f"select/{rate}/{name}"]
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), (rate, name)
        for name in ("mask", "nnz", "abs_mask", "abs_nnz"):
            got, want = res[f"select/{rate}/{name}"]
            assert np.array_equal(got, want), (rate, name)
        # ties span both ranks: some cut segment's kept entries lie on each
        assert res[f"select/{rate}/abs_nnz"][0].min() > 0


def test_group_select_through_the_scheme(world2):
    for res in world2:
        got, want = res["scheme/payload"]
        assert np.array_equal(got, want)
        got, want = res["scheme/nnz"]
        assert np.array_equal(got, want) and got.min() > 0
        assert res["scheme/total"].tolist() == [sum(math.prod(s) for s, _ in
                                                    ranks.SELECT.values())] * 2


def test_clipped_dense_step_matches_one_rank(world2):
    for res in world2:
        n = len([k for k in res if k.startswith("clip/one/") and k[9:].isdigit()])
        assert n > 0
        for i in range(n):
            assert max_rel(res[f"clip/tp/{i}"], res[f"clip/one/{i}"]) <= REL, i
        assert int(res["clip/tp/total"]) == int(res["clip/one/total"])


@pytest.mark.parametrize("wire", ranks.ENGINE_WIRES)
@pytest.mark.parametrize("arch", ranks.ENGINE_ARCHS)
def test_engine_at_model_two_is_the_one_rank_engine(world2, arch, wire):
    kv = tconfigs.get_smoke(arch).num_kv_heads
    for res in world2:
        got, want = res[f"engine/{arch}/{wire}/tp"], res[f"engine/{arch}/{wire}/one"]
        assert got.size == want.size > 0 and np.array_equal(got, want), (arch, wire)
        assert int(res[f"engine/{arch}/{wire}/tp/kv"]) == (kv // 2 if kv % 2 == 0 else kv)
    assert np.array_equal(world2[0][f"engine/{arch}/{wire}/tp"],
                          world2[1][f"engine/{arch}/{wire}/tp"])


# ---------------------------------------------------------------------------
# the group mode, emulated
# ---------------------------------------------------------------------------


def sample_ranks(k: int, whole: int, ns: int) -> tuple[int, int]:
    """``sample_ranks`` of ``csrc/gmf_compress.cu``: the sample's ranks k *
    ns / whole -+ (4 standard deviations + 1), within [1, ns]."""
    q = min(max(k / whole if whole > 0 else 1.0, 0.0), 1.0)
    r = q * ns
    d = 4.0 * math.sqrt(ns * q * (1.0 - q)) + 1.0
    return max(1, math.floor(r - d)), min(ns, math.ceil(r + d))


def sample_bracket(bits: torch.Tensor, k: int, whole: int) -> tuple[int, int]:
    """``group_sample``: a piece's bracket [lo, hi] of pass 0's bins, from
    the top digits of ``GROUP_SAMPLE`` of its score bits at a fixed
    stride."""
    n = bits.numel()
    ns = min(n, gk.GROUP_SAMPLE)
    hist = torch.bincount(bits[torch.arange(ns, dtype=torch.int64) * n // ns] >> 21,
                          minlength=2048)
    r_lo, r_hi = sample_ranks(k, whole, ns)
    return sel.scan_from_top(hist, r_hi)[0], sel.scan_from_top(hist, r_lo)[0]


def group_kth_largest(pieces, k: int, tile: int):
    """The k-th largest of a leaf whose ranks hold ``pieces`` (non-negative
    float32 scores) as the group mode finds it. Each rank draws its sample
    and takes its bracket; in pass 0 it counts every score of its tiles and
    keeps those whose top digit lies in its bracket as the tile's
    candidates (at most ``candidate_slots``); the ranks' histograms are
    summed (the all-reduce) and the next pass scans the sum from the top
    (``scan_bins``, as each of its blocks does). In passes 1 and 2 a tile
    counts its candidates where the digit found lies in its rank's bracket
    and the tile did not overflow, else it reads its scores in full.
    Returns (the threshold, each rank's path a tile: "candidates", "miss"
    or "overflow")."""
    bits = [p.reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF for p in pieces]
    whole = sum(b.numel() for b in bits)
    brackets = [sample_bracket(b, k, whole) for b in bits]
    tiles = []  # per rank: (scores, kept candidates, appended) a tile
    hist = torch.zeros(2048, dtype=torch.int64)
    for b, (lo, hi) in zip(bits, brackets, strict=True):
        plan = gk.plan_select([b.numel()], tile)
        caps = gk.candidate_slots(plan.blocks[:, 2])
        own = []
        for (_, start, length), cap in zip(plan.blocks.tolist(), caps.tolist(), strict=True):
            part = b[start:start + length]
            hist += torch.bincount(part >> 21, minlength=2048)
            hits = part[((part >> 21) >= lo) & ((part >> 21) <= hi)]
            own.append((part, hits[:cap], hits.numel()))
        tiles.append(own)
    d0, rank = sel.scan_from_top(hist, k)
    prefix, pmask = d0 << 21, 0x7FF << 21
    paths = [["candidates" if lo <= d0 <= hi and n <= len(kept) else
              "miss" if not lo <= d0 <= hi else "overflow" for _, kept, n in own]
             for own, (lo, hi) in zip(tiles, brackets, strict=True)]
    for shift, width in ((10, 11), (0, 10)):
        dmask = (1 << width) - 1
        hist = torch.zeros(2048, dtype=torch.int64)
        for own, path in zip(tiles, paths, strict=True):
            for (part, kept, _), how in zip(own, path, strict=True):
                src = kept if how == "candidates" else part
                cand = src[(src & pmask) == prefix]
                hist += torch.bincount((cand >> shift) & dmask, minlength=2048)
        digit, rank = sel.scan_from_top(hist, rank)
        prefix |= digit << shift
        pmask |= dmask << shift
    thr = torch.tensor([prefix], dtype=torch.int64).to(torch.int32).view(torch.float32)[0]
    return thr, paths


# Pieces built for the group mode's paths at k = 10 % of the leaf: shares
# of "large" scores (spread over 20 bins, [2, 64)), of one bin B ([1, 1.2))
# and of "medium" ones (the four bins under B, [0.55, 0.95)), the rest
# "small" ([0.01, 0.5)). The ranks but the last take the kind's pieces but
# the last in turn, the last rank its last piece. The k-th largest lies in B.
GROUP_PIECES = {
    # each rank's 10 % falls in the large or the medium scores: every bracket misses
    "misses": [dict(large=0.14, b=0.04), dict(b=0.04, medium=0.20)] * 2,
    # each rank's 10 % falls in B, which holds 30 % of each tile: every tile overflows
    "overflow": [dict(large=0.05, b=0.30)] * 2,
    # the last rank's 10 % falls in its large scores: it misses, the others hit
    "one_misses": [dict(large=0.055, b=0.09), dict(large=0.14, b=0.09)],
}


def group_pieces(kind: str, ranks_: int, n: int = 12_000, seed: int = 5):
    """The pieces of an ``n``-element leaf over ``ranks_`` ranks: the column
    pieces of ``_scores``' kinds, or a ``GROUP_PIECES`` kind."""
    if kind not in GROUP_PIECES:
        return list(sel._scores(n, kind, seed=3).reshape(100, 120).chunk(ranks_, dim=1))
    rng = np.random.default_rng(seed)
    shares = GROUP_PIECES[kind]
    out = []
    for r in range(ranks_):
        mix = shares[-1] if r == ranks_ - 1 else shares[r % (len(shares) - 1)]
        m = n // ranks_
        counts = {k: int(round(f * m)) for k, f in mix.items()}
        counts["small"] = m - sum(counts.values())
        span = {"large": (2.0, 64.0), "b": (1.0, 1.2), "medium": (0.55, 0.95),
                "small": (0.01, 0.5)}
        x = np.concatenate([rng.uniform(*span[k], size=c) for k, c in counts.items()])
        out.append(torch.from_numpy(rng.permutation(x).astype(np.float32)))
    return out


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "equal", "tiny", *GROUP_PIECES])
@pytest.mark.parametrize("ranks_, tile", [(2, 4096), (2, 1000), (4, 1000)])
def test_group_mode_histograms_give_the_whole_leafs_threshold(kind, ranks_, tile):
    """A 12,000-element leaf cut over 2 or 4 ranks, each piece in one or
    many tiles: the column pieces of ``_scores``' kinds (each rank's piece
    strided in the leaf's order), or pieces built for a path
    (``GROUP_PIECES``): every bracket missing the k-th largest's top digit,
    every tile overflowing its candidate slots, one rank missing while the
    others hit. Whatever path each tile takes, the threshold is bitwise
    ``torch.topk``'s over the whole leaf."""
    pieces = group_pieces(kind, ranks_)
    z = torch.cat([p.reshape(-1) for p in pieces])
    for k in sorted({1, 1200, 6000, 12_000}):
        got, paths = group_kth_largest(pieces, k, tile)
        want = torch.topk(z, k).values[-1]
        assert got.view(torch.int32) == want.view(torch.int32), (kind, ranks_, tile, k)
        if kind in GROUP_PIECES and k == 1200:
            want_paths = {"misses": ["miss"] * ranks_, "overflow": ["overflow"] * ranks_,
                          "one_misses": ["candidates"] * (ranks_ - 1) + ["miss"]}[kind]
            assert [set(p) for p in paths] == [{w} for w in want_paths], (kind, paths)
    if kind == "normal":  # the |z| of normal draws: the bracket holds at 10 %
        assert {"candidates"} == set().union(*group_kth_largest(pieces, 1200, tile)[1])


def test_group_plan_puts_cut_segments_first():
    """``select_table(..., group=)``: the cut leaves are split leaves
    whatever their tile count, first among them, the rest as in the
    single launch's plan."""
    sizes = [70_000, 50, 3, 90_000, 8]
    plan = gk.plan_select(sizes, 65_536)
    one = gk.select_table(plan, "cpu")
    grp = gk.select_table(plan, "cpu", group=[False, True, False, True, False])
    assert one.n_group is None and (one.n_local, one.n_split) == (3, 2)
    assert grp.n_group == 2 and (grp.n_local, grp.n_split) == (2, 3)
    host = grp.table.numpy()
    local = host[:3 * grp.n_local].reshape(-1, 3)
    split = host[3 * grp.n_local:3 * grp.n_local + grp.n_split]
    assert local[:, 0].tolist() == [4, 2] and split.tolist() == [1, 3, 0]
    tiles = host[3 * grp.n_local + 2 * grp.n_split + 1:].reshape(-1, 5)
    assert len(tiles) == grp.n_tiles == 1 + 2 + 2
    assert tiles[:, 0].tolist() == [0, 1, 1, 2, 2] and tiles[:, 1].tolist() == [1, 3, 3, 0, 0]


def _bits(x):
    return x.view(np.int32) if x.dtype == np.float32 else x


def check_stage(world2, name):
    """``STAGE_CASES[name]`` over the two ranks against the one-rank run on
    the whole leaves; returns whether its piece-local version differed on
    every rank."""
    differs = []
    sketch = resolve(CompressionConfig(**ranks.STAGE_CASES[name])).is_sketch
    for r, res in enumerate(world2):
        key = f"stage/{name}"
        assert res[f"{key}/cut"].tolist() == [ranks.STAGES[k][1] is not None
                                              for k in sorted(ranks.STAGES)]
        held = [k for k in res if k.startswith(key + "/") and "local" not in k
                and k.rsplit("/", 1)[1] not in ("cut", "total")]
        assert {f"{key}/payload", f"{key}/bcast", f"{key}/upload_nnz"} <= set(held)
        for k in held:
            got, want = res[k]
            assert got.shape == want.shape, (r, k, got.shape, want.shape)
            if sketch and k.rsplit("/", 1)[1] in ("payload", "s_err"):
                err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
                assert err <= SKETCH_REL, (r, k, err)
            else:
                assert np.array_equal(_bits(got), _bits(want)), (r, k)
        n = sum(math.prod(s) for s, _ in ranks.STAGES.values())
        assert res[f"{key}/total"].tolist() == [n] * 4, (r, res[f"{key}/total"])
        assert res[f"{key}/upload_nnz"][0].min() > 0
        loc, pay = res[f"{key}/local_payload"], res[f"{key}/payload"][0]
        lbc, bc = res[f"{key}/local_bcast"], res[f"{key}/bcast"][0]
        differs.append(not (loc.shape == pay.shape and np.array_equal(loc, pay)
                            and np.array_equal(lbc, bc)))
    return all(differs)


@pytest.mark.parametrize("name", [k for k in ranks.STAGE_CASES if "=" not in k])
def test_cut_stage_paths_are_the_whole_leaves(world2, name):
    """The cut stages' other paths (fused sampled, adaptive rates through
    the sampled and global selectors, the downlink's variants)."""
    assert check_stage(world2, name), (name, "the piece-local version gives the same")


@pytest.mark.parametrize("k", ranks.HITTER_KS)
def test_cut_hitters_break_ties_by_whole_index(world2, k):
    """FetchSGD's hitters over the two ranks take the whole model's, ties
    (which span both ranks) to the lower whole-tree index."""
    for res in world2:
        got, want = res[f"hitters/{k}"]
        assert np.array_equal(_bits(got), _bits(want)), k
    assert sum(np.count_nonzero(res[f"hitters/{k}"][1]) for res in world2) > 0


@pytest.mark.parametrize("kw", ranks.ALLOWED + ranks.REFUSED, ids=ranks.kw_id)
def test_stages_over_a_model_axis(world2, kw):
    """Every composition runs over the model group and gives the rank's
    piece of the one-rank run on the whole leaves; for the eight that cut or
    key a leaf by flat coordinate (once refused), the piece-local version
    differs."""
    differs = check_stage(world2, ranks.kw_id(kw))
    if kw in ranks.REFUSED:
        assert differs, (kw, "the piece-local version gives the same")


@pytest.mark.parametrize("name", list(ranks.MIXED_CASES))
def test_mixed_dtype_stages_over_a_model_axis(world2, name):
    """The stages that work across leaves or key draws by leaf, on a tree of
    three dtype groups (bfloat16 and float32 with cut and whole leaves, a
    float16 group of one whole leaf) cut over the model axis: the rank's
    pieces of the one-rank run on the whole leaves, bitwise (the sketch
    within SKETCH_REL, its server bitwise on the same summed sketch)."""
    sketch = resolve(CompressionConfig(**ranks.MIXED_CASES[name])).is_sketch
    key = f"mixed/{name}"
    for r, res in enumerate(world2):
        cut, indexed = res[f"{key}/groups"]
        assert cut.tolist() == [True, True, False]  # bf16, f32; the f16 group whole
        assert indexed.all()  # every group's tree_index over the whole tree's sizes
        dts = res[f"{key}/bcast_dtypes"].tolist()
        assert dts[:3] == dts[3:], (r, dts)
        held = [k for k in res if k.startswith(key + "/")
                and k.rsplit("/", 1)[1] not in ("groups", "bcast_dtypes")]
        assert {f"{key}/payload", f"{key}/bcast", f"{key}/upload_nnz"} <= set(held)
        for k in held:
            got, want = res[k]
            assert got.shape == want.shape, (r, k, got.shape, want.shape)
            if sketch and k.rsplit("/", 1)[1] in ("payload", "s_err"):
                err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
                assert err <= SKETCH_REL, (r, k, err)
            else:
                assert np.array_equal(_bits(got), _bits(want)), (r, k)
        assert res[f"{key}/upload_nnz"][0].min() > 0


def test_mixed_dtype_gmf_step_over_a_model_axis(world2):
    """granite-moe's gmf_data step in bfloat16 (float32 routers) under global
    top-k at (1, 2), fed the same gradient as the mesh-less step: the whole
    params after it bitwise, the upload and download counts equal."""
    for res in world2:
        assert set(res["mixed_step/dtypes"].tolist()) == {"torch.bfloat16", "torch.float32"}
        assert res["mixed_step/cut"].any()
        for i in range(len(res["mixed_step/dtypes"])):
            got, want = res[f"mixed_step/tp/{i}"], res[f"mixed_step/one/{i}"]
            assert np.array_equal(_bits(got), _bits(want)), i
        assert res["mixed_step/tp/counts"].tolist() == res["mixed_step/one/counts"].tolist()
        assert res["mixed_step/one/counts"].min() > 0
