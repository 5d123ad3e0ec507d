"""What the port's kernel wrappers decide on the host, held on the CPU:
K2's launch plan and leaf table, ``gmf_select``'s plan of tiles (each leaf
covered once, in order, the first-tile prefix, its device table, the cache
per layout, the 32-bit limit), K4's choice between its two kernels and
the layouts its tensor-core kernel refuses, and the ctypes signatures of
every C entry point against the CUDA sources.

K2's table is held by running the kernel's own walk over it in numpy: every
block finds its leaf by the first-block prefix and reads and writes through
the table's raw pointers, which on the CPU are host addresses. So the plan,
the table, the alignment flags and the output views are checked end to end
here; only the CUDA code itself needs the card (``chip_smoke.py``).
"""

import bisect
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)

from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import gmf_compress as gk
from repro_torch.kernels import ref

CSRC = Path(gk.__file__).resolve().parent / "csrc"


# ---------------------------------------------------------------------------
# K2: plan and table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("count, capacity, launches", [
    (1, 1, 1), (4, 4, 1), (5, 4, 2), (8, 4, 2), (9, 4, 3), (169, 512, 1), (513, 512, 2),
])
def test_k2_plan_cuts_leaves_into_tables_of_capacity(count, capacity, launches):
    plan = gk.plan_momentum([7] * count, capacity, 4)
    assert len(plan) == launches
    assert all(1 <= len(p.leaves) <= capacity for p in plan)
    assert [i for p in plan for i in p.leaves] == list(range(count))


def test_k2_plan_leaves_out_empty_leaves_and_prefixes_blocks():
    sizes = [0, 8, 9, 0, 1, 16, 0]
    (plan,) = gk.plan_momentum(sizes, 8, 8)
    assert plan.leaves == (1, 2, 4, 5)
    # ceil(size / chunk) blocks each: 1, 2, 1, 2
    assert plan.block0 == (0, 1, 3, 4)
    assert plan.blocks == 6
    assert gk.plan_momentum([0, 0], 4, 8) == []
    assert gk.plan_momentum([], 4, 8) == []


def test_k2_plan_restarts_the_prefix_in_every_launch():
    plan = gk.plan_momentum([5, 20, 3], 2, 8)
    assert [(p.leaves, p.block0, p.blocks) for p in plan] == [((0, 1), (0, 1), 4),
                                                             ((2,), (0,), 1)]


@pytest.mark.parametrize("capacity, chunk", [(0, 8), (4, 0)])
def test_k2_plan_refuses_a_nonpositive_limit(capacity, chunk):
    with pytest.raises(ValueError):
        gk.plan_momentum([4], capacity, chunk)


def _floats(ptr, n):
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(int(ptr))) if n else \
        np.zeros(0, np.float32)


def _rows(table):
    """Each launch's table as the C entry point reads it: per leaf the
    pointers u, v, g, u', v', the element count, the first block and the
    alignment flag."""
    out = []
    for leaves, count, _ in table.launches:
        assert leaves.dtype == np.int64 and leaves.shape == (count, 8)
        assert leaves.flags.c_contiguous
        out.append([tuple(int(x) for x in row) for row in leaves])
    return out


def _run_table(us, vs, gs, alpha, capacity, chunk):
    """The kernel's walk in numpy: per launch, per block, the leaf by a
    binary search of the table's first-block prefix, then chunk elements of
    it read and written through the table's pointers (float4 or scalar path
    alike: both compute U <- alpha*U + g ; V <- V + U per element). Returns
    the outputs, the flags in leaf order and how often each output element
    was written."""
    table = gk.momentum_table(us, vs, gs, capacity, chunk)
    hits = {}
    flags = []
    a = np.float32(alpha)
    for rows, (_, count, blocks) in zip(_rows(table), table.launches, strict=True):
        assert 1 <= count <= capacity
        starts = [r[6] for r in rows]
        for b in range(blocks):
            u, v, g, u2, v2, n, block0, _ = rows[bisect.bisect_right(starts, b) - 1]
            begin = (b - block0) * chunk
            end = min(begin + chunk, n)
            u, v, g, u2, v2 = (_floats(p, n) for p in (u, v, g, u2, v2))
            un = a * u[begin:end] + g[begin:end]
            u2[begin:end] = un
            v2[begin:end] = v[begin:end] + un
            hits.setdefault(u2.ctypes.data, np.zeros(n, np.int64))[begin:end] += 1
        flags += [r[7] for r in rows]
    return table.uo, table.vo, flags, hits


def _leaves(rng, shapes, misalign=()):
    out = []
    for j, shape in enumerate(shapes):
        n = int(np.prod(shape))
        x = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        if j in misalign:
            buf = torch.empty(n + 1)
            buf[1:] = x
            x = buf[1:]
        out.append(x.reshape(shape))
    return out


@pytest.mark.parametrize("capacity, chunk", [(512, 4096), (3, 8), (1, 4)])
def test_k2_table_walk_is_bitwise_the_plain_version(capacity, chunk):
    """ResNet-like leaves for 3 clients, empty leaves, sizes off the float4
    grid and one misaligned leaf, through small and real table limits."""
    rng = np.random.default_rng(0)
    shapes = [(3, 3, 3, 3, 16), (3, 16), (3, 0), (3, 7), (3, 1), (3, 3, 3, 16, 16),
              (3, 64, 10), (3, 5)]
    us, vs, gs = (_leaves(rng, shapes, misalign={3} if k == 1 else ()) for k in range(3))
    uo, vo, aligned, hits = _run_table(us, vs, gs, 0.9, capacity, chunk)
    want_u, want_v = ref.momentum_correction(us, vs, gs, 0.9)
    for got, want in ((uo, want_u), (vo, want_v)):
        for a, b in zip(got, want, strict=True):
            assert a.shape == b.shape and torch.equal(a, b)
    # every element of every non-empty u' leaf written exactly once
    assert len(hits) == 7 and all((h == 1).all() for h in hits.values())
    # The outputs lie leaf after leaf, at float offsets 0, 1296, 1344, 1344,
    # 1365, 1368, 8280, 10200: leaf 4 starts off the 16-byte grid, and leaf 3's
    # v input starts one float past it; both take the scalar path. (Leaf 2 is
    # empty: it is not in the table and launches nothing.)
    assert aligned == [1, 1, 0, 0, 1, 1, 1]


def test_k2_outputs_are_views_of_one_buffer_each():
    rng = np.random.default_rng(1)
    shapes = [(2, 3), (2, 0), (2, 5, 2), (1,)]
    us, vs, gs = (_leaves(rng, shapes) for _ in range(3))
    table = gk.momentum_table(us, vs, gs, 8, 4)
    (rows,) = _rows(table)
    assert [r[5:7] for r in rows] == [(6, 0), (20, 2), (1, 7)]  # n, first block
    assert table.launches[0][1:] == (3, 8)
    for outs, col in ((table.uo, 3), (table.vo, 4)):
        base = outs[0].untyped_storage().data_ptr()
        assert all(o.untyped_storage().data_ptr() == base for o in outs if o.numel())
        assert all(o.is_contiguous() for o in outs)
        # leaf after leaf at float offsets 0, 6, 6, 26; an empty leaf has no
        # storage of its own (and no row in the table)
        assert [o.data_ptr() - base for o in outs if o.numel()] == [0, 24, 104]
        assert [o.data_ptr() for o in outs if o.numel()] == [r[col] for r in rows]
    assert [tuple(o.shape) for o in table.uo] == shapes
    assert [r[7] for r in rows] == [1, 0, 0]


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided"])
def test_k2_table_refuses_what_the_kernel_cannot_take(bad):
    x = torch.zeros(2, 4)
    y = {"dtype": x.double(), "shape": torch.zeros(4, 2), "strided": torch.zeros(4, 2).t()}[bad]
    with pytest.raises(ValueError):
        gk.momentum_table([x, x], [x, y], [x, x], 8, 4)


@pytest.mark.parametrize("odd", [0, 2])
def test_k2_tree_on_the_cpu_refuses_a_leaf_elsewhere(odd):
    """The tree path goes by its first leaf: a leaf on another device raises
    rather than taking the plain version (or, first, the kernel)."""
    from repro_torch.kernels import ops

    x = torch.zeros(2, 4)
    leaves = [x, x, x]
    leaves[odd] = torch.zeros(2, 4, device="meta")
    tree = {f"l{i}": t for i, t in enumerate(leaves)}
    with pytest.raises(ValueError, match="meta"):
        ops.momentum_correction(tree, tree, tree, 0.9)


def test_k2_tree_launcher_refuses_cpu_tensors():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="cuda"):
        gk.momentum_correction_tree([x], [x], [x], 0.9)
    assert gk.momentum_correction_tree([], [], [], 0.9) == ([], [])


# ---------------------------------------------------------------------------
# gmf_select: the plan of tiles and its device table
# ---------------------------------------------------------------------------

TILE = 1024


def _resnet56_sizes():
    from repro_torch.models import resnet
    from repro_torch.utils.flat import FlatLayout

    params = resnet.init_resnet(torch.Generator().manual_seed(0), depth=56)
    return list(FlatLayout.of(params).sizes)


def _assert_tiles_cover(plan, sizes):
    """Every leaf's tiles, in order: its first tile from the prefix, starts
    0, tile, 2 tile, ..., lengths of at most one tile adding up to the
    leaf, and an empty leaf one empty tile."""
    tile = plan.tile
    assert plan.first[0] == 0 and len(plan.first) == len(sizes) + 1
    assert plan.blocks.dtype == np.int64 and plan.blocks.shape == (plan.first[-1], 3)
    assert plan.total == sum(sizes)
    for i, n in enumerate(sizes):
        rows = plan.blocks[plan.first[i]:plan.first[i + 1]]
        assert len(rows) == max(1, -(-n // tile)), (i, n)
        assert (rows[:, 0] == i).all()
        assert rows[:, 1].tolist() == [t * tile for t in range(len(rows))]
        assert (rows[:, 2] <= tile).all() and (rows[:, 2] >= 0).all()
        assert int(rows[:, 2].sum()) == n
        assert (rows[:-1, 2] == tile).all()  # only the last one short


@pytest.mark.parametrize("sizes", [
    [0], [1], [TILE - 1], [TILE], [TILE + 1], [268_435_456],
    [0, 1, TILE - 1, TILE, TILE + 1, 5 * TILE + 3, 0, 7],
], ids=["0", "1", "tile-1", "tile", "tile+1", "2^28", "mixed"])
def test_select_plan_tiles_cover_each_leaf_once_in_order(sizes):
    _assert_tiles_cover(gk.plan_select(sizes, TILE), sizes)


def test_select_plan_tiles_cover_resnet56():
    sizes = _resnet56_sizes()
    assert len(sizes) == 169 and sum(sizes) == 855_578
    for tile in (TILE, 16_384, gk.select_tile(sizes)):
        _assert_tiles_cover(gk.plan_select(sizes, tile), sizes)


def test_select_plan_first_tile_prefix():
    plan = gk.plan_select([5, 0, 3 * TILE, TILE + 1, TILE], TILE)
    # 1 + 1 + 3 + 2 + 1 tiles
    assert plan.first.tolist() == [0, 1, 2, 5, 7, 8]
    assert plan.blocks[plan.first[3]].tolist() == [3, 0, TILE]
    assert plan.blocks[plan.first[3] - 1].tolist() == [2, 2 * TILE, TILE]
    assert plan.blocks[plan.first[4] - 1].tolist() == [3, TILE, 1]


@pytest.mark.parametrize("n", [2**32, 2**32 + 5, 2**40])
def test_select_plan_refuses_a_segment_past_32_bit_counts(n):
    """The kernel's ranks and histogram counts are 32-bit unsigned."""
    with pytest.raises(ValueError, match="32-bit"):
        gk.plan_select([3, n], 65_536)


def test_select_plan_takes_the_largest_32_bit_segment():
    plan = gk.plan_select([2**32 - 1], 2**20)
    assert plan.first.tolist() == [0, 4096] and int(plan.blocks[-1, 2]) == 2**20 - 1


@pytest.mark.parametrize("tile", [0, -4])
def test_select_plan_refuses_a_nonpositive_tile(tile):
    with pytest.raises(ValueError):
        gk.plan_select([4], tile)


@pytest.mark.parametrize("sizes, tile", [
    ([855_578], 53_248), ([292_560], 16_384), ([1_498_482_688], 65_536), ([0], 16_384),
    ([16 * 40_000 + 15], 36_864),
])
def test_select_tile_is_a_sixteenth_of_a_row_within_bounds(sizes, tile):
    """ResNet-56's row (its 36,864-element leaves whole), the char-LSTM's
    (its 262,144-element leaf split), llama3.2-1b's and the bounds."""
    assert gk.select_tile(sizes) == tile


def test_select_table_lists_local_leaves_largest_first_and_split_tiles():
    sizes = [5, 0, 3 * TILE, TILE + 1, TILE, 700]
    table = gk.select_table(gk.plan_select(sizes, TILE), "cpu")
    assert (table.n_local, table.n_split, table.n_tiles) == (4, 2, 5)
    host = table.table.tolist()
    local, split = np.array(host[:12]).reshape(4, 3), host[12:14]
    first, tiles = host[14:17], np.array(host[17:]).reshape(-1, 5)
    # (leaf, first column, length): sizes 1024, 700, 5, 0
    o = np.cumsum([0] + sizes).tolist()
    assert local.tolist() == [[4, o[4], TILE], [5, o[5], 700], [0, 0, 5], [1, 5, 0]]
    assert split == [2, 3]
    assert first == [0, 3, 5]
    # (split index, leaf, first column, length, tiles of the leaf)
    assert tiles.tolist() == [[0, 2, o[2], TILE, 3], [0, 2, o[2] + TILE, TILE, 3],
                              [0, 2, o[2] + 2 * TILE, TILE, 3], [1, 3, o[3], TILE, 2],
                              [1, 3, o[3] + TILE, 1, 2]]
    assert table.scratch == {}


def test_select_plan_is_cached_per_layout_and_tile():
    from repro_torch.utils.flat import FlatLayout

    layout = FlatLayout.of_sizes([3, 70_000, 0, 16_384], "cpu")
    plan = layout.select_plan()
    assert plan is layout.select_plan()
    assert plan.plan.tile == gk.select_tile(layout.sizes) == 16_384
    want = gk.plan_select(layout.sizes, 16_384)
    assert np.array_equal(plan.plan.blocks, want.blocks)
    # another tile length is a table of its own, made outside the layout
    other = gk.select_table(gk.plan_select(layout.sizes, 4096), "cpu")
    assert other.plan.tile == 4096 and (other.n_local, other.n_split) == (2, 2)
    assert layout.select_plan() is plan
    assert (plan.n_local, plan.n_split, plan.n_tiles) == (3, 1, 5)
    assert plan.table.dtype == torch.int64 and plan.table.device.type == "cpu"
    # another layout object of the same sizes is the same cached layout
    assert FlatLayout.of_sizes([3, 70_000, 0, 16_384], "cpu").select_plan() is plan


@pytest.mark.parametrize("lengths, slots", [
    ([0, 1, 4, 16, 17, 31, 32, 33, 65_536], [0, 4, 4, 4, 8, 8, 8, 12, 16_384]),
    ([700, TILE, 1], [176, 256, 4]),
])
def test_group_candidate_slots_are_a_quarter_of_each_tile_in_quads(lengths, slots):
    assert gk.candidate_slots(lengths).tolist() == slots


def test_group_table_and_scratch_hold_the_candidates():
    """The group mode's plan: each split leaf's whole size, each tile's
    first candidate slot in a row; its scratch for a row count: three
    passes' histograms, the states, the tiles' counts and ``rows`` times a
    row's slots, made once per (rows, stream) like the rest. The single
    launch's table has no candidates."""
    sizes = [5, 0, 3 * TILE, TILE + 1, TILE, 700]
    plan = gk.plan_select(sizes, TILE)
    whole = [5, 0, 6 * TILE, 2 * TILE + 2, TILE, 1400]
    grp = gk.select_table(plan, "cpu", group=[False, True, True, True, False, True],
                          whole=whole)
    assert (grp.n_group, grp.n_local, grp.n_split, grp.n_tiles) == (4, 2, 4, 7)
    # split leaves 1, 2, 3, 5; tiles 0 | 1024 x 3 | 1024, 1 | 700
    caps = [0, 256, 256, 256, 256, 4, 176]
    first = np.concatenate([[0], np.cumsum(caps)]).tolist()
    assert grp.group_plan.tolist() == [0, 6 * TILE, 2 * TILE + 2, 1400] + first
    assert grp.slots == sum(caps) == 1204
    rows = 3
    assert gk.group_scratch(grp, rows) == {
        "part": rows * (7 + 4) * 2, "cand": rows * 1204,
        "buf": rows * (4 * (3 * 2048 + gk.GROUP_STATE_WORDS) + 7)}
    part, buf, cand = gk._select_scratch(grp, rows, "cpu", 0)
    assert (part.dtype, buf.dtype, cand.dtype) == (torch.float64, torch.int32, torch.int32)
    assert cand.numel() == rows * 1204 and not buf.any()
    assert all(a is b for a, b in zip(gk._select_scratch(grp, rows, "cpu", 0),
                                      (part, buf, cand), strict=True))
    assert gk._select_scratch(grp, 2, "cpu", 0)[2].numel() == 2 * 1204
    assert gk._select_scratch(grp, rows, "cpu", 7)[2] is not cand
    assert set(grp.scratch) == {(3, 0), (2, 0), (3, 7)}
    one = gk.select_table(plan, "cpu")
    assert one.group_plan is None and one.slots == 0
    assert gk.group_scratch(one, rows) == {"part": rows * (5 + 2) * 2, "cand": 0,
                                           "buf": rows * 2 * (2048 + 4) + 2}
    # the whole sizes default to the plan's, and must name every leaf
    assert gk.select_table(plan, "cpu", group=[True] * 6).group_plan[:6].tolist() == sizes
    with pytest.raises(ValueError, match="whole sizes"):
        gk.select_table(plan, "cpu", group=[True] * 6, whole=[1, 2])


def test_group_layout_plan_reads_the_whole_sizes():
    """``FlatLayout.select_plan(group=True)`` hands the layout's whole sizes
    (``full_sizes``, the leaves' over the group) and cut flags to the
    table: here those a piece of each leaf over a group of two would have."""
    from repro_torch.utils.flat import FlatLayout

    layout = FlatLayout.of_sizes([6, 70_000, 9], "cpu")
    layout.full_sizes, layout.cut_flags = (12, 140_000, 9), (True, True, False)
    plan = layout.select_plan(group=True)
    assert (plan.n_group, plan.n_split, plan.n_local) == (2, 2, 1)
    assert plan.group_plan[:plan.n_split].tolist() == [12, 140_000]
    assert plan.slots == gk.candidate_slots(plan.plan.blocks[:1 + 5, 2]).sum()


def test_group_constants_match_the_kernel():
    text = (CSRC / "gmf_compress.cu").read_text()
    assert re.search(r"constexpr int kSample = (\d+);", text).group(1) == str(gk.GROUP_SAMPLE)
    words = re.search(r"enum : int \{([^}]*)\}", text).group(1).split(",")
    assert words[-1].strip() == "kStateWords" and len(words) - 1 == gk.GROUP_STATE_WORDS


def test_select_wrappers_refuse_a_plan_of_another_layout():
    from repro_torch.utils.flat import FlatLayout

    layout = FlatLayout.of_sizes([3, 5], "cpu")
    other = FlatLayout.of_sizes([4, 4], "cpu").select_plan()
    plan = layout.select_plan()
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="plan"):
        gk._select_plan("gmf_select", other, torch.zeros(2, 9), 2)
    with pytest.raises(TypeError, match="SelectTable"):
        gk._select_plan("gmf_select", plan.plan, x, 2)
    gk._select_plan("gmf_select", plan, x, 2)


# ---------------------------------------------------------------------------
# K4: which kernel, and what the tensor-core kernel refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, d, kernel", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 112, "tc"), (torch.bfloat16, 256, "tc"),
    (torch.bfloat16, 16, "cc"), (torch.bfloat16, 32, "cc"),
    (torch.float32, 16, "cc"), (torch.float32, 32, "cc"),
    (torch.float32, 64, "cc"), (torch.float32, 128, "cc"),
    (torch.float32, 112, "cc"), (torch.float32, 256, "cc"),
])
def test_k4_kernel_choice_by_dtype_and_head_dim(dtype, d, kernel):
    assert k4.kernel_for(dtype, d) == kernel


def test_k4_tensor_core_dispatch_covers_exactly_its_head_dims():
    """The head dims ``flash_attention_sm90_fwd`` launches an instance for
    are ``TC_HEAD_DIMS``, each on the instance of its own D: a head dim
    ``kernel_for`` sends there but the dispatch lacks would fail on the
    card only."""
    text = re.sub(r"//[^\n]*", "", (CSRC / "flash_attention_sm90.cu").read_text())
    start = text.index("flash_attention_sm90_fwd(")
    body = text[text.index("{", start):]
    branches = re.findall(r"if \(d == (\d+)\) return launch<(\d+)>\(", body)
    assert branches and all(d == inst for d, inst in branches)
    assert tuple(sorted(int(d) for d, _ in branches)) == k4.TC_HEAD_DIMS
    assert set(k4.TC_HEAD_DIMS) <= set(k4.HEAD_DIMS)


@pytest.mark.parametrize("d", [112, 256])
def test_k4_tensor_core_layout_takes_the_new_head_dims(d):
    """Contiguous (B, T, H, D) and (BH, T, D) views at D 112 and 256 meet
    the tensor maps' rules (a D 112 row is 224 bytes); a D 112 slice of a
    wider buffer whose head stride is 116 elements (232 bytes) does not."""
    assert k4.tma_layout_error(torch.zeros(2, 10, 4, d, dtype=torch.bfloat16)) is None
    kv = torch.zeros(2, 10, 8, d, dtype=torch.bfloat16)[:, :, :2]
    assert k4.tma_layout_error(kv) is None
    bhsd = torch.zeros(8, 10, d, dtype=torch.bfloat16)
    assert k4.tma_layout_error(bhsd.unsqueeze(0).transpose(1, 2)) is None
    if d == 112:
        wide = torch.zeros(2, 10, 4, 116, dtype=torch.bfloat16)[..., :112]
        assert "multiple of 16 bytes" in k4.tma_layout_error(wide)
        assert k4.kernel_for(wide.dtype, wide.shape[-1]) == "tc"


def test_k4_tensor_core_layout_takes_the_model_and_pallas_views():
    q = torch.zeros(2, 10, 4, 64, dtype=torch.bfloat16)
    assert k4.tma_layout_error(q) is None
    # (BH, T, D) seen as (1, T, BH, D): strides not ordered by size
    bhsd = torch.zeros(8, 10, 128, dtype=torch.bfloat16)
    assert k4.tma_layout_error(bhsd.unsqueeze(0).transpose(1, 2)) is None
    # k/v of fewer kv heads, sliced out of a wider tensor
    assert k4.tma_layout_error(torch.zeros(2, 10, 8, 64, dtype=torch.bfloat16)[:, :, :2]) is None
    # a size-1 dim's stride is never stepped, so any value is fine
    assert k4.tma_layout_error(torch.zeros(1, 10, 1, 64, dtype=torch.bfloat16)
                               .as_strided((1, 10, 1, 64), (3, 64, 5, 1))) is None


@pytest.mark.parametrize("view, why", [
    (lambda b: b[1:1 + 2 * 10 * 4 * 64].view(2, 10, 4, 64), "16-byte aligned"),
    (lambda b: b[:2 * 10 * 4 * 68].view(2, 10, 4, 68)[..., :64], "multiple of 16 bytes"),
    (lambda b: b[4:4 + 2 * 10 * 4 * 64].view(2, 10, 4, 64), "16-byte aligned"),
    (lambda b: b[:2 * 12 * 4 * 64].view(2, 12, 4, 64)[:, ::3], None),
])
def test_k4_misaligned_bf16_is_refused_not_rerouted(view, why):
    buf = torch.zeros(2 * 12 * 4 * 68 + 8, dtype=torch.bfloat16)
    x = view(buf)
    got = k4.tma_layout_error(x)
    if why is None:
        assert got is None
    else:
        assert why in got
        # the choice of kernel does not look at the layout: the input still
        # belongs to the tensor-core kernel, whose wrapper raises
        assert k4.kernel_for(x.dtype, x.shape[-1]) == "tc"


def test_ptxas_report_reads_each_instance_of_a_template():
    from repro_torch.kernels import build

    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114flash_fwd_sm90ILi256EEEv14"
        "CUtensorMap_stS1_S1_S1_iiiifi' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_114flash_fwd_sm90ILi256EEEv",
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19other_kernelEPf' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114flash_fwd_sm90ILi64EEEv14"
        "CUtensorMap_st' for 'sm_90a'",
        "ptxas info    : Used 93 registers, used 16 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    ])
    assert build.ptxas_report(log, "flash_fwd_sm90") == {
        256: {"registers": 168, "spill_stores": 12, "spill_loads": 16},
        64: {"registers": 93, "spill_stores": 0, "spill_loads": 0}}


def test_k4_launch_refuses_cpu_tensors_for_either_kernel():
    for dtype, d in ((torch.bfloat16, 64), (torch.float32, 32)):
        q = torch.zeros(1, 4, 2, d, dtype=dtype)
        with pytest.raises(ValueError, match="cuda"):
            k4._launch_bthd(q, q, q, torch.empty_like(q), True)


# ---------------------------------------------------------------------------
# ctypes signatures against the C entry points
# ---------------------------------------------------------------------------


def _c_entry_points(text):
    """name -> list of parameter types of every ``extern "C"`` function,
    whether declared alone or inside an ``extern "C" { ... }`` block."""
    text = re.sub(r"//[^\n]*", "", text)
    bodies = [m.group(0) for m in re.finditer(r'extern "C"\s+\w[^;{]*\([^)]*\)', text)]
    for block in re.finditer(r'extern "C"\s*\{', text):
        depth, i = 1, block.end()
        start = i
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        inner = text[start:i - 1]
        # top-level declarations of the block: strip the function bodies
        flat, depth = [], 0
        for ch in inner:
            if ch == "{":
                depth += 1
                flat.append(";")
            elif ch == "}":
                depth -= 1
            elif depth == 0:
                flat.append(ch)
        bodies += re.findall(r"\w[\w\s\*]*\([^)]*\)", "".join(flat))
    out = {}
    for decl in bodies:
        head, params = decl.split("(", 1)
        name = head.split()[-1].lstrip("*")
        params = [p.strip() for p in params.rstrip(")").split(",") if p.strip()]
        out[name] = [] if params == ["void"] else params
    return out


def _ctype_of(param):
    """The ctypes type a C parameter needs (the name is the last word)."""
    words = param.replace("*", " * ").split()
    if "*" in words:
        return ctypes.c_void_p
    kind = " ".join(w for w in words[:-1] if w not in ("const", "unsigned"))
    return {"long long": ctypes.c_longlong, "int": ctypes.c_int,
            "float": ctypes.c_float}[kind]


@pytest.mark.parametrize("source, signatures", [
    ("gmf_compress.cu", gk.SIGNATURES),
    ("flash_attention.cu", k4.SIGNATURES),
    ("flash_attention_sm90.cu", k4.TC_SIGNATURES),
])
def test_every_c_entry_point_matches_its_ctypes_argtypes(source, signatures):
    """A pointer or a long long bound as ctypes' default int is cut to 32
    bits without a word; so every extern "C" function must be bound, with
    as many argtypes as it has parameters, each of the matching width."""
    entry = _c_entry_points((CSRC / source).read_text())
    assert entry and set(entry) == set(signatures), (sorted(entry), sorted(signatures))
    for name, params in entry.items():
        argtypes, _ = signatures[name]
        assert len(argtypes) == len(params), (name, params)
        assert [_ctype_of(p) for p in params] == list(argtypes), (name, params)


def test_every_csrc_source_is_bound():
    assert {p.name for p in CSRC.glob("*.cu")} == {
        "gmf_compress.cu", "flash_attention.cu", "flash_attention_sm90.cu"}
