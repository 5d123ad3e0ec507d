"""Build, binding and launch of the CUDA compression kernels.

The kernels live in ``csrc/gmf_compress.cu`` behind a plain C interface,
built at first use by ``kernels/build.py`` (nvcc for ``sm_90a``, loaded
with ctypes). Nothing is built when this module is imported.

Each ``*_flat`` wrapper takes ``[k, ...]`` CUDA tensors (one row per
client) of float32 or bfloat16, checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch failed, and adds one to the count of
its dtype instance in ``INSTANCES`` (``LAUNCHES`` sums them by kernel).
There is no fallback: a tensor the kernel does not take raises.

Dtypes follow the reference (``csrc/gmf_compress.cu`` says how each
kernel rounds): the state (u, v) is of one type S, the gradient, the
global momentum or the mask may be of another, and the outputs are of the
type jnp's promotion gives (float32 unless both are bfloat16), or of S
where the caller asks for the Pallas kernel's semantics (``out_dtype``).

K1 and its glue take the flat compression state (``utils/flat.py``): a
``[k, N]`` stack of L leaf segments, described by the layout's int64
offsets ``[L + 1]`` on the device and a keep count per segment: an int64
``[L]`` array shared by every row (a fixed rate) or a ``[k, L]`` table of
per-client counts (adaptive rates), read with a row stride of 0 or L.
``gmf_select_flat`` gives each segment's inverse norms and exact top-k
threshold, ``[k, L]`` each, and ``gmf_compress_flat`` is the fused mask
pass over the whole stack; ``topk_abs_select_flat`` is the same select on
``|z|`` with the mask, for DGC's top-k. The select takes the layout's plan
(``plan_select``, made once per layout by ``FlatLayout.select_plan`` at
the tile length ``select_tile`` gives it): a segment of at most one tile
is one block, a larger one is split over many, in one launch whose phases
are separated by grid-wide barriers (``csrc/gmf_compress.cu``). Each
wrapper call counts as one ``gmf_select`` launch in ``INSTANCES``, in
either mode, whatever the number of CUDA kernels it issues. K3 (``apply_mask_flat``) takes any
stack, the flat one included.

``gmf_select``'s group mode (a plan made with ``select_table(...,
group=...)``) selects a layout whose segments are cut over a process group
of ranks (tensor parallelism's model group): its steps as separate
launches on the stream (6 fused, 5 in the |z| mode), and between them one
``all_reduce`` over the group of the cut segments' float64 norm sums, then
of each radix pass's integer histograms; nothing is read back to the
host. It reads the stack twice in full: pass 0 keeps aside the scores in
a bracket that a sample foretells, and passes 1 and 2 count those alone
where the bracket holds (``csrc/gmf_compress.cu`` says how).
Integer histograms sum exactly in any order, so each threshold is the
k-th largest of the whole leaf. At a group of one (or ``group=None``) it
is bitwise the single launch; its calls count as ``gmf_select`` launches
of a ``group:`` instance.

K2 (``momentum_correction_tree``) is one multi-tensor launch over every
leaf of a tree: ``plan_momentum`` cuts the leaves into launches of at most
the table's capacity and gives each leaf its first block,
``momentum_table`` packs each launch's table, and
``momentum_correction_flat`` is the same call over a one-leaf tree.
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Mapping
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.build import BASE_FLAGS, bind, build_library
from repro_torch.utils.device import weak

SOURCE = Path(__file__).resolve().parent / "csrc" / "gmf_compress.cu"
# -fmad=false: K1's z must be bitwise the z its threshold was taken from.
NVCC_FLAGS = (*BASE_FLAGS, "-fmad=false")

KERNEL_NAMES = ("gmf_select", "gmf_compress", "momentum_correction", "apply_mask")
# Launches per (kernel, operand dtypes) instance since the last
# reset_launches(), e.g. ("momentum_correction", "bf16,bf16->bf16"): the
# evidence that a run went through the kernels, and which instances it took.
INSTANCES: dict[tuple[str, str], int] = {}
# The group mode's all-reduces over its group by instance since the last
# reset_launches() (counted apart: they are collectives, not launches).
GROUP_SUMS: dict[str, int] = {}


class _Launches(Mapping):
    """Launches per kernel since the last reset: ``INSTANCES`` summed over
    each kernel's instances (read-only)."""

    def __getitem__(self, name: str) -> int:
        if name not in KERNEL_NAMES:
            raise KeyError(name)
        return sum(n for (kernel, _), n in INSTANCES.items() if kernel == name)

    def __iter__(self):
        return iter(KERNEL_NAMES)

    def __len__(self) -> int:
        return len(KERNEL_NAMES)


LAUNCHES = _Launches()

# The dtype codes of the C interface.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    INSTANCES.clear()
    GROUP_SUMS.clear()
    FAKE_LAUNCHES.clear()


def instance(*dtypes, out=None) -> str:
    """An instance's name from its operand dtypes: ``"bf16,f32->f32"``."""
    name = ",".join(_SHORT[d] for d in dtypes)
    return name if out is None else f"{name}->{_SHORT[out]}"


def build() -> Path:
    """The shared library's path, compiled first if need be."""
    return build_library(SOURCE, NVCC_FLAGS)


_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# (argtypes, restype) of every extern "C" function of csrc/gmf_compress.cu.
SIGNATURES = {
    "gmf_momentum_limits": ([_P, _P], None),
    "gmf_momentum_multi": ([_P, _I32, _I32, _F32, _I32, _I32, _I32, _P], _I32),
    "gmf_apply_mask": ([_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P], _I32),
    "gmf_select": ([_P, _P, _P, _I32, _I32, _I32, _P, _I32, _P, _P, _F32, _I32, _I64, _I64, _I32,
                    _P, _P, _P, _P, _P, _P, _I32, _I32, _P], _I32),
    "gmf_select_abs": ([_P, _P, _I32, _I32, _I32, _P, _I32, _I32, _I64, _I64, _I32, _P, _P, _P,
                        _P, _I32, _P], _I32),
    "gmf_compress": ([_P] * 8 + [_I32, _I64] + [_P] * 4 + [_I64, _I32, _I32, _I32, _P], _I32),
    "gmf_select_group": ([_I32, _I32, _P, _P, _P, _I32, _I32, _I32, _P, _P, _I32, _P, _P, _F32,
                          _I32, _I64, _I64, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32,
                          _P], _I32),
    "gmf_select_abs_group": ([_I32, _I32, _P, _P, _I32, _I32, _I32, _P, _P, _I32, _I32, _I64,
                              _I64, _I32, _P, _P, _P, _P, _P, _P, _I32, _P], _I32),
}


@functools.cache
def library() -> ctypes.CDLL:
    return bind(ctypes.CDLL(str(build())), SIGNATURES)


@functools.cache
def momentum_limits() -> tuple[int, int]:
    """(leaves a K2 launch's table holds, elements a block takes), as built."""
    cap, chunk = ctypes.c_int(), ctypes.c_int()
    library().gmf_momentum_limits(ctypes.byref(cap), ctypes.byref(chunk))
    return cap.value, chunk.value


class MomentumLaunch(NamedTuple):
    leaves: tuple[int, ...]  # indices into the tree's leaves
    block0: tuple[int, ...]  # each leaf's first block
    blocks: int              # the grid


def plan_momentum(sizes, capacity: int, chunk: int) -> list[MomentumLaunch]:
    """K2's launches over leaves of ``sizes`` elements: leaves of 0
    elements are left out, the rest go in order into launches of at most
    ``capacity`` leaves, and each leaf takes ``ceil(size / chunk)`` blocks
    from its launch's running prefix."""
    if capacity < 1 or chunk < 1:
        raise ValueError(f"capacity {capacity} and chunk {chunk} must be positive")
    live = [i for i, n in enumerate(sizes) if n]
    plan = []
    for lo in range(0, len(live), capacity):
        idx = tuple(live[lo:lo + capacity])
        block0, total = [], 0
        for i in idx:
            block0.append(total)
            total += -(-sizes[i] // chunk)
        plan.append(MomentumLaunch(idx, tuple(block0), total))
    return plan


# The tile length of a layout's gmf_select plan (``select_tile``): a leaf of
# at most one tile is selected whole by one block, a larger one is split over
# ceil(n / tile) blocks. The length is a row's elements over SELECT_SHARE,
# rounded down to a multiple of 4,096 and held within [SELECT_TILE_MIN,
# SELECT_TILE_MAX]: no block selects more than about a sixteenth of a row,
# and a layout of many leaves keeps them whole (tools/torch_select_tiles.py
# times the choices).
SELECT_SHARE = 16
SELECT_TILE_MIN, SELECT_TILE_MAX = 16_384, 65_536
# The rank and the histogram counts are 32-bit unsigned in the kernel.
SELECT_MAX_SEGMENT = 2**32 - 1
# The group mode's sample draws at most GROUP_SAMPLE scores of a segment's
# piece (``csrc/gmf_compress.cu``: kSample); a tile keeps at most 1 /
# GROUP_CAND_SHARE of its scores as candidates (``candidate_slots``): at a
# rate of 0.1 a bracket of one or two bins holds up to ~15 % of the scores
# (14 % of llama3.2-1b's bf16 row in the fused mode, PERF.md), past an
# eighth.
GROUP_SAMPLE, GROUP_CAND_SHARE = 16_384, 4
# The group mode's words of state a split segment (kStateWords).
GROUP_STATE_WORDS = 8


class SelectPlan(NamedTuple):
    """``gmf_select``'s tiles of a layout's leaves (``plan_select``)."""
    tile: int
    first: np.ndarray   # int64 [L + 1]: leaf i's tiles are blocks[first[i]:first[i + 1]]
    blocks: np.ndarray  # int64 [tiles, 3]: (leaf, start in the leaf, length) per tile
    total: int          # elements of a row


def select_tile(sizes) -> int:
    """The tile length of the plan of a layout of leaves of ``sizes``."""
    share = -(-sum(int(n) for n in sizes) // SELECT_SHARE)
    return min(SELECT_TILE_MAX, max(SELECT_TILE_MIN, share // 4096 * 4096))


def plan_select(sizes, tile: int) -> SelectPlan:
    """Each leaf of ``sizes`` elements cut into ``tile``-element tiles from
    its start, the last one short; a leaf of 0 elements takes one empty
    tile, so every leaf has at least one. Refuses a leaf the kernel's
    32-bit ranks and counts cannot hold."""
    if tile < 1:
        raise ValueError(f"tile {tile} must be positive")
    sizes = np.asarray(sizes, dtype=np.int64).reshape(-1)
    if sizes.size and int(sizes.max()) > SELECT_MAX_SEGMENT:
        raise ValueError(f"gmf_select takes segments of at most {SELECT_MAX_SEGMENT} elements "
                         f"(32-bit ranks and counts), got {int(sizes.max())}")
    counts = np.maximum(1, -(-sizes // tile))
    first = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    leaf = np.repeat(np.arange(sizes.size, dtype=np.int64), counts)
    start = (np.arange(int(first[-1]), dtype=np.int64) - first[leaf]) * tile
    length = np.minimum(tile, sizes[leaf] - start)
    return SelectPlan(tile, first, np.stack([leaf, start, length], axis=1), int(sizes.sum()))


class SelectTable(NamedTuple):
    """A ``SelectPlan`` as the kernel reads it, on the device: one int64
    array of the local leaves (one tile: one block selects each whole)
    ``[n_local, 3]`` as (leaf, first column, length), largest first; the
    split leaves; each split leaf's first tile (``n_split + 1``); and the
    split leaves' tiles ``[n_tiles, 5]`` as (split index, leaf, first
    column, length, tiles of the leaf), the columns a row's. ``scratch``
    caches the split leaves' scratch per (rows, stream). ``n_group`` is
    None but in a group mode's table, where it counts the segments cut over
    the group: the first ``n_group`` split leaves. ``owners`` is None, or,
    where some cut segment's piece is another rank's to count, its factor
    on each cut segment's sums and histograms before they are summed over
    the group: ``[n_group, 1]`` float64 and int32 device tensors of 1 (this
    rank owns its piece) and 0. ``group_plan`` (a group mode's table only)
    is int64 on the device: each split leaf's whole size over the group
    ``[n_split]``, then each tile's first candidate slot in a row ``[n_tiles
    + 1]`` (``candidate_slots``). It follows ``table`` in one buffer, so a
    group step takes the table alone (``_group_plan_ptr``): each argument of
    an operator costs host time at every call. ``slots`` is a row's
    candidate slots."""
    table: torch.Tensor
    n_local: int
    n_split: int
    n_tiles: int
    plan: SelectPlan
    scratch: dict
    n_group: int | None = None
    owners: tuple | None = None
    group_plan: torch.Tensor | None = None
    slots: int = 0


def candidate_slots(lengths) -> np.ndarray:
    """The group mode's candidate slots of tiles of ``lengths`` elements:
    a quarter of each (``GROUP_CAND_SHARE``), rounded up to a multiple of
    4 so that every tile's slots start 16-byte aligned."""
    caps = -(-np.asarray(lengths, dtype=np.int64) // GROUP_CAND_SHARE)
    return (caps + 3) // 4 * 4


def select_table(plan: SelectPlan, device, group=None, owners=None, whole=None) -> SelectTable:
    """``plan``'s device table, for ``FlatLayout.select_plan`` to make once.
    ``group`` (a bool a leaf) makes the group mode's table: the flagged
    leaves are split ones whatever their tile count, and come first;
    ``owners`` (a bool a leaf, default all) whether this rank's piece of a
    flagged leaf counts in the group's sums; ``whole`` (an int a leaf,
    default the plan's sizes) each leaf's size over the group, which the
    group mode's sample reads its keep count against."""
    counts = np.diff(plan.first)
    sizes = np.add.reduceat(plan.blocks[:, 2], plan.first[:-1]) if counts.size else counts
    offsets = np.cumsum(sizes) - sizes
    cut = np.zeros(counts.size, bool) if group is None else np.asarray(group, bool)
    if cut.shape != counts.shape:
        raise ValueError(f"group flags for {cut.size} leaves, the plan has {counts.size}")
    local = np.flatnonzero((counts == 1) & ~cut)
    local = local[np.argsort(-sizes[local], kind="stable")]
    split = np.concatenate([np.flatnonzero(cut), np.flatnonzero((counts > 1) & ~cut)])
    tiles = np.zeros((int(counts[split].sum()), 5), np.int64)
    if split.size:
        blocks = np.concatenate([plan.blocks[plan.first[i]:plan.first[i + 1]] for i in split])
        tiles[:, 0] = np.repeat(np.arange(split.size), counts[split])
        tiles[:, 1] = blocks[:, 0]
        tiles[:, 2] = offsets[blocks[:, 0]] + blocks[:, 1]
        tiles[:, 3] = blocks[:, 2]
        tiles[:, 4] = counts[blocks[:, 0]]
    first = np.concatenate([[0], np.cumsum(counts[split])])
    local = np.stack([local, offsets[local], sizes[local]], axis=1)
    host = np.concatenate([local.reshape(-1), split, first, tiles.reshape(-1)]).astype(np.int64)
    own = None
    if group is not None and owners is not None and not np.asarray(owners, bool)[cut].all():
        flags = np.asarray(owners, bool)[cut].reshape(-1, 1)
        own = (torch.as_tensor(flags.astype(np.float64)).to(device),
               torch.as_tensor(flags.astype(np.int32)).to(device))
    if group is None:
        return SelectTable(torch.as_tensor(host).to(device), len(local), int(split.size),
                           len(tiles), plan, {})
    whole = sizes if whole is None else np.asarray(whole, dtype=np.int64).reshape(-1)
    if whole.shape != counts.shape:
        raise ValueError(f"whole sizes for {whole.size} leaves, the plan has {counts.size}")
    first_slot = np.concatenate([[0], np.cumsum(candidate_slots(tiles[:, 3]))])
    both = torch.as_tensor(np.concatenate([host, whole[split], first_slot]).astype(np.int64))
    both = both.to(device)
    return SelectTable(both[:host.size], len(local), int(split.size), len(tiles), plan, {},
                       int(cut.sum()), own, both[host.size:], int(first_slot[-1]))


def _check_stack(name: str, *xs: torch.Tensor) -> None:
    ref = xs[0]
    if ref.dim() < 1:
        raise ValueError(f"{name}: operands need a leading client axis, got a 0-dim tensor")
    for x in xs:
        if not x.is_cuda or x.device != ref.device:
            raise ValueError(f"{name}: the kernel takes tensors on one cuda device, got "
                             f"{x.device} beside {ref.device}")
        if x.dtype not in DTYPE_CODES:
            raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {x.dtype}")
        if x.shape != ref.shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(ref.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _check_rows(name: str, shape: tuple, like: torch.Tensor, *scalars: torch.Tensor,
                dtype=torch.float32) -> None:
    for s in scalars:
        if (not s.is_cuda or s.device != like.device or s.dtype != dtype
                or tuple(s.shape) != shape or not s.is_contiguous()):
            raise ValueError(
                f"{name}: scalars must be contiguous {dtype} {list(shape)} tensors on "
                f"{like.device}, got {s.dtype} {tuple(s.shape)} on {s.device}")


def _segments(name: str, x: torch.Tensor, offsets: torch.Tensor) -> int:
    """The leaf count of ``offsets`` (int64 ``[L + 1]`` on x's device) for
    the ``[rows, N]`` stack ``x``."""
    if x.dim() != 2:
        raise ValueError(f"{name}: the kernel takes a flat [rows, N] stack, got "
                         f"{tuple(x.shape)}")
    leaves = offsets.numel() - 1
    if leaves < 1:
        raise ValueError(f"{name}: a layout of at least one leaf is needed")
    _check_rows(name, (leaves + 1,), x, offsets, dtype=torch.int64)
    return leaves


def _keep_stride(name: str, keep: torch.Tensor, like: torch.Tensor, leaves: int) -> int:
    """The row stride of the keep table ``keep``: 0 for int64 ``[L]`` counts
    shared by every row of ``like`` (or a ``[rows, L]`` view of them with
    row stride 0), ``L`` for a contiguous ``[rows, L]`` table."""
    rows = like.shape[0]
    if keep.dim() == 1:
        _check_rows(name, (leaves,), like, keep, dtype=torch.int64)
        return 0
    if keep.dim() == 2 and keep.stride() == (0, 1):
        _check_rows(name, (leaves,), like, keep[0], dtype=torch.int64)
        return 0
    _check_rows(name, (rows, leaves), like, keep, dtype=torch.int64)
    return leaves


def _same_dtype(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != b.dtype:
        raise TypeError(f"{name}: u and v must share a dtype, got {a.dtype} and {b.dtype}")


def _out_dtype(name: str, state, other, out_dtype):
    """jnp's promotion of ``state`` with ``other`` (``out_dtype=None``), or
    ``out_dtype``, which may only be that or ``state``."""
    promoted = torch.promote_types(state, other)
    if out_dtype is None:
        return promoted
    if out_dtype not in (promoted, state):
        raise TypeError(f"{name}: outputs of {out_dtype} from {state} and {other}")
    return out_dtype


def _vec(*xs: torch.Tensor) -> int:
    """1 where every pointer is aligned to a quad (4 elements) of its type."""
    return int(all(x.data_ptr() % (4 * x.element_size()) == 0 for x in xs))


def _stream(device) -> int:
    """The current stream of ``device`` as the raw handle the kernels take
    (torch's own getter: a Stream object costs more host time than a short
    launch); 0 where torch has no CUDA runtime (tensors traced by shape)."""
    if not torch.cuda.is_available():
        return 0
    return torch._C._cuda_getCurrentRawStream(device.index)


def _on(device, fn, *args) -> int:
    """``fn(*args, stream)`` with ``device`` current, on its current stream."""
    stream = _stream(device)
    if device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def _launch(name: str, fn, device, *args, inst: str = "", stream: int | None = None) -> None:
    if stream is None:
        err = _on(device, fn, *args)
    elif device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    INSTANCES[name, inst] = INSTANCES.get((name, inst), 0) + 1


# ---------------------------------------------------------------------------
# The launches as torch operators
# ---------------------------------------------------------------------------
#
# Each launch is a ``torch.library.custom_op`` with a CUDA implementation
# (the ctypes call above) and a fake one (``register_fake``): the
# counterpart of a Pallas call's ``out_shape``. The wrappers allocate every
# output and scratch buffer with torch before the launch and the operator
# writes them (``mutates_args``), so a pass over fake tensors
# (``torch._subclasses.FakeTensorMode``, ``launch/dryrun.py``) allocates
# what the card allocates, issues the same collectives between launches,
# and launches nothing: the fake implementation only counts the launch in
# ``FAKE_LAUNCHES``. A CPU tensor has no implementation and raises.

# Launches traced by shape (fake implementations) per kernel since the last
# reset_launches(); never counted in INSTANCES / LAUNCHES.
FAKE_LAUNCHES: dict[str, int] = {}


def _fake(name: str) -> None:
    FAKE_LAUNCHES[name] = FAKE_LAUNCHES.get(name, 0) + 1


def _op(name: str, mutates: tuple, kernel: str):
    """``fn`` as the CUDA implementation of the operator ``repro_torch::name``
    that writes ``mutates``, with a fake implementation that counts one
    ``kernel`` launch."""
    def deco(fn):
        op = torch.library.custom_op(f"repro_torch::{name}", mutates_args=mutates,
                                     device_types="cuda")(fn)

        @op.register_fake
        def _(*args, **kwargs):
            _fake(kernel)

        return op

    return deco


@_op("momentum_multi_", ("flat_u", "flat_v"), "momentum_correction")
def _momentum_op(us: list[torch.Tensor], vs: list[torch.Tensor], gs: list[torch.Tensor],
                 flat_u: torch.Tensor, flat_v: torch.Tensor, alpha: float) -> None:
    table = momentum_table(us, vs, gs, *momentum_limits(), out_dtype=flat_u.dtype,
                           out=(flat_u, flat_v))
    launch_momentum(table, alpha, flat_u.device)


@_op("apply_mask_", ("go", "uo", "vo"), "apply_mask")
def _mask_op(u: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, go: torch.Tensor,
             uo: torch.Tensor, vo: torch.Tensor) -> None:
    o = go.dtype
    _launch("apply_mask", library().gmf_apply_mask, u.device,
            u.data_ptr(), v.data_ptr(), mask.data_ptr(), go.data_ptr(), uo.data_ptr(),
            vo.data_ptr(), u.numel(), _vec(u, v, mask, go, uo, vo),
            DTYPE_CODES[v.dtype], DTYPE_CODES[mask.dtype], DTYPE_CODES[o],
            inst=instance(v.dtype, mask.dtype, out=o))


@_op("gmf_compress_", ("go", "uo", "vo", "mo"), "gmf_compress")
def _compress_op(u: torch.Tensor, v: torch.Tensor, m: torch.Tensor, inv_norm_v: torch.Tensor,
                 inv_norm_m: torch.Tensor, threshold: torch.Tensor, tau: torch.Tensor,
                 offsets: torch.Tensor, go: torch.Tensor, uo: torch.Tensor, vo: torch.Tensor,
                 mo: torch.Tensor) -> None:
    leaves = offsets.numel() - 1
    _launch("gmf_compress", library().gmf_compress, u.device,
            u.data_ptr(), v.data_ptr(), m.data_ptr(), inv_norm_v.data_ptr(),
            inv_norm_m.data_ptr(), threshold.data_ptr(), tau.data_ptr(), offsets.data_ptr(),
            leaves, u.shape[1], go.data_ptr(), uo.data_ptr(), vo.data_ptr(), mo.data_ptr(),
            u.numel(), _vec(u, v, m, go, uo, vo, mo), DTYPE_CODES[v.dtype],
            DTYPE_CODES[m.dtype], inst=instance(v.dtype, m.dtype))


def _scratch_ptrs(part: torch.Tensor, buf: torch.Tensor, rows: int, n_split: int):
    """The select scratch's addresses: the partials, the histograms and the
    segment states (after the histograms in the int32 buffer)."""
    return part.data_ptr(), buf.data_ptr(), buf.data_ptr() + 4 * rows * n_split * 2048


@_op("gmf_select_", ("inv_nv", "inv_nm", "thr", "part", "buf"), "gmf_select")
def _select_op(v: torch.Tensor, m: torch.Tensor, table: torch.Tensor, keep: torch.Tensor,
               w: torch.Tensor, tau: torch.Tensor, inv_nv: torch.Tensor, inv_nm: torch.Tensor,
               thr: torch.Tensor, part: torch.Tensor, buf: torch.Tensor, n_local: int,
               n_split: int, n_tiles: int, stride: int, eps: float) -> None:
    rows, leaves = thr.shape
    p, h, st = _scratch_ptrs(part, buf, rows, n_split)
    _launch("gmf_select", library().gmf_select, v.device,
            v.data_ptr(), m.data_ptr(), table.data_ptr(), n_local, n_split, n_tiles,
            keep.data_ptr(), stride, w.data_ptr(), tau.data_ptr(), float(eps), leaves, rows,
            v.shape[1], _vec(v, m), inv_nv.data_ptr(), inv_nm.data_ptr(), thr.data_ptr(), p, h,
            st, DTYPE_CODES[v.dtype], DTYPE_CODES[m.dtype], inst=instance(v.dtype, m.dtype))


@_op("gmf_select_abs_", ("thr", "mask", "part", "buf"), "gmf_select")
def _select_abs_op(z: torch.Tensor, table: torch.Tensor, keep: torch.Tensor, thr: torch.Tensor,
                   mask: torch.Tensor, part: torch.Tensor, buf: torch.Tensor, n_local: int,
                   n_split: int, n_tiles: int, stride: int) -> None:
    rows, leaves = thr.shape
    _, h, st = _scratch_ptrs(part, buf, rows, n_split)
    _launch("gmf_select", library().gmf_select_abs, z.device,
            z.data_ptr(), table.data_ptr(), n_local, n_split, n_tiles, keep.data_ptr(), stride,
            leaves, rows, z.shape[1], _vec(z, mask), thr.data_ptr(), mask.data_ptr(), h, st,
            DTYPE_CODES[z.dtype], inst="abs:" + instance(z.dtype))


def _group_launched(err: int, step: int, pas: int, inst: str) -> None:
    """Raise for a failed group-mode step; count a select's launch at its
    first step."""
    if err != 0:
        raise RuntimeError(f"gmf_select (group mode, step {step}, pass {pas}): CUDA launch "
                           f"failed with cudaError_t {err}")
    if step == 0:
        INSTANCES["gmf_select", inst] = INSTANCES.get(("gmf_select", inst), 0) + 1


def _group_ptrs(part: torch.Tensor, buf: torch.Tensor, rows: int, n_split: int, n_tiles: int):
    """The group mode's scratch addresses (``group_scratch``): the tile
    partials, the split segments' sums, the three passes' histograms, the
    segment states and the tiles' candidate counts."""
    hist = 3 * rows * n_split * 2048
    state = buf.data_ptr() + 4 * hist
    return (part.data_ptr(), part.data_ptr() + 8 * rows * n_tiles * 2, buf.data_ptr(), state,
            state + 4 * rows * n_split * GROUP_STATE_WORDS)


def _group_plan_ptr(table: torch.Tensor) -> int:
    """The address of a group table's ``group_plan``, which follows it."""
    return table.data_ptr() + 8 * table.numel()


# The group mode's steps, one launch each: the steps of one select count as
# one gmf_select launch; the fake counts each step. Every step is called
# six or five times a select, so each takes few arguments (a custom op's
# host time grows with its argument count): the outputs as the one buffer
# they are views of, ``sizes`` = (n_local, n_split, n_tiles, keep stride).
@_op("gmf_select_group_", ("out", "part", "buf", "cand"), "gmf_select_step")
def _select_group_op(step: int, pas: int, v: torch.Tensor, m: torch.Tensor,
                     table: torch.Tensor, keep: torch.Tensor, w: torch.Tensor,
                     tau: torch.Tensor, out: torch.Tensor, part: torch.Tensor,
                     buf: torch.Tensor, cand: torch.Tensor, sizes: list[int],
                     eps: float) -> None:
    n_local, n_split, n_tiles, stride = sizes
    _, rows, leaves = out.shape  # inv_nv, inv_nm, thr
    each = 4 * rows * leaves
    o = out.data_ptr()
    err = _on(v.device, library().gmf_select_group,
              step, pas, v.data_ptr(), m.data_ptr(), table.data_ptr(), n_local, n_split, n_tiles,
              _group_plan_ptr(table), keep.data_ptr(), stride, w.data_ptr(), tau.data_ptr(),
              float(eps), leaves, rows, v.shape[1], _vec(v, m), o, o + each, o + 2 * each,
              *_group_ptrs(part, buf, rows, n_split, n_tiles), cand.data_ptr(),
              DTYPE_CODES[v.dtype], DTYPE_CODES[m.dtype])
    _group_launched(err, step, pas, "group:" + instance(v.dtype, m.dtype))


@_op("gmf_select_abs_group_", ("out", "part", "buf", "cand"), "gmf_select_step")
def _select_abs_group_op(step: int, pas: int, z: torch.Tensor, table: torch.Tensor,
                         keep: torch.Tensor, out: torch.Tensor, part: torch.Tensor,
                         buf: torch.Tensor, cand: torch.Tensor, sizes: list[int]) -> None:
    n_local, n_split, n_tiles, stride = sizes
    rows, n = z.shape
    leaves = (out.numel() - z.numel()) // rows  # the mask [rows, n], then thr [rows, leaves]
    _, _, h, st, counts = _group_ptrs(part, buf, rows, n_split, n_tiles)
    err = _on(z.device, library().gmf_select_abs_group,
              step, pas, z.data_ptr(), table.data_ptr(), n_local, n_split, n_tiles,
              _group_plan_ptr(table), keep.data_ptr(), stride, leaves, rows, n, _vec(z, out),
              out.data_ptr() + 4 * z.numel(), out.data_ptr(), h, st, counts, cand.data_ptr(),
              DTYPE_CODES[z.dtype])
    _group_launched(err, step, pas, "group:abs:" + instance(z.dtype))


class MomentumTable(NamedTuple):
    uo: list        # u' leaves: views into one flat buffer, leaf after leaf
    vo: list        # v' leaves, likewise
    launches: list  # (table, leaves, blocks) per launch; the table is [leaves, 8]
    #                 int64: u, v, g, u', v', n, first block, aligned
    dtypes: tuple = (torch.float32, torch.float32, torch.float32)  # S, G, O


def _momentum_dtype(us, vs, gs, out_dtype=None):
    """K2's checks of its leaves (one device, contiguity, matching shapes,
    u and v of one type S and g of one type G, each float32 or bfloat16)
    -> the outputs' dtype (jnp's promotion of S and G, or ``out_dtype``)."""
    name = "momentum_correction"
    if not (len(us) == len(vs) == len(gs)):
        raise ValueError(f"{name}: {len(us)}, {len(vs)}, {len(gs)} leaves")
    device = us[0].device
    s_dtype, g_dtype = us[0].dtype, gs[0].dtype
    if any(not x.is_contiguous() or x.device != device or x.dtype != want
           or want not in DTYPE_CODES
           for xs, want in ((us, s_dtype), (vs, s_dtype), (gs, g_dtype)) for x in xs):
        raise ValueError(f"{name}: the kernel takes contiguous float32 or bfloat16 tensors "
                         f"on {device}, u and v of one dtype and g of one dtype")
    shapes = [u.shape for u in us]
    if shapes != [v.shape for v in vs] or shapes != [g.shape for g in gs]:
        raise ValueError(f"{name}: u, v and g leaves differ in shape")
    return _out_dtype(name, s_dtype, g_dtype, out_dtype)


def momentum_table(us, vs, gs, capacity: int, chunk: int, out_dtype=None,
                   out=None) -> MomentumTable:
    """The host half of K2 over lists of leaves, on any device: checks the
    leaves (``_momentum_dtype``); allocates u' and v' of ``out_dtype``
    (default jnp's promotion of S and G) as views into one flat buffer each
    (or takes the two flat buffers ``out``); and packs each launch of
    ``plan_momentum`` into the int64 table the C entry point reads. The
    alignment flag is 1 where all five pointers of a leaf are aligned to a
    quad of their type (16 bytes for float32). The host work is a pass over
    the leaves per step and numpy columns, with no allocation per leaf but
    the output views."""
    o_dtype = _momentum_dtype(us, vs, gs, out_dtype)
    device = us[0].device
    s_dtype, g_dtype = us[0].dtype, gs[0].dtype
    sizes = [u.numel() for u in us]
    if out is None:
        flat_u = torch.empty(sum(sizes), dtype=o_dtype, device=device)
        flat_v = torch.empty_like(flat_u)
    else:
        flat_u, flat_v = out
    uo, vo = _unflatten(flat_u, us), _unflatten(flat_v, us)
    table = np.empty((len(us), 8), dtype=np.int64)
    for col, xs in enumerate((us, vs, gs)):
        table[:, col] = [x.data_ptr() for x in xs]
    table[:, 5] = sizes
    starts = flat_u.element_size() * (np.cumsum(table[:, 5]) - table[:, 5])
    table[:, 3] = flat_u.data_ptr() + starts
    table[:, 4] = flat_v.data_ptr() + starts
    quad = [4 * torch.empty((), dtype=d).element_size()
            for d in (s_dtype, s_dtype, g_dtype, o_dtype, o_dtype)]
    table[:, 7] = np.all(table[:, :5] % np.array(quad, np.int64) == 0, axis=1)
    launches = []
    for launch in plan_momentum(sizes, capacity, chunk):
        rows = table if len(launch.leaves) == len(us) else table[list(launch.leaves)]
        rows[:, 6] = launch.block0
        launches.append((rows, len(launch.leaves), launch.blocks))
    return MomentumTable(uo, vo, launches, (s_dtype, g_dtype, o_dtype))


def _unflatten(flat, like):
    """Views of ``flat`` shaped like the tensors ``like``, one after the
    other (torch's own C++ split, as distributed data parallel uses)."""
    return torch._C._nn.unflatten_dense_tensors(flat, like)


def launch_momentum(table: MomentumTable, alpha: float, device) -> None:
    """K2's launches of ``table`` on ``device``'s current stream; alpha is
    rounded to the state's dtype, as JAX rounds a weakly typed scalar."""
    s, g, o = table.dtypes
    codes = (DTYPE_CODES[s], DTYPE_CODES[g], DTYPE_CODES[o])
    for leaves, count, blocks in table.launches:
        _launch("momentum_correction", library().gmf_momentum_multi, device,
                leaves.ctypes.data, count, blocks, weak(alpha, s), *codes,
                inst=instance(s, g, out=o))


def momentum_correction_tree(us, vs, gs, alpha: float, out_dtype=None):
    """U <- alpha*U + g ; V <- V + U over lists of leaves on one cuda
    device (``momentum_table`` says what it takes), one launch per table's
    capacity of leaves. Returns (u' list, v' list): views into one flat
    buffer each."""
    if not us:
        return [], []
    device = us[0].device
    if device.type != "cuda":
        raise ValueError(f"momentum_correction: the kernel takes cuda tensors, got {device}")
    o_dtype = _momentum_dtype(us, vs, gs, out_dtype)
    flat_u = torch.empty(sum(u.numel() for u in us), dtype=o_dtype, device=device)
    flat_v = torch.empty_like(flat_u)
    _momentum_op(list(us), list(vs), list(gs), flat_u, flat_v, float(alpha))
    return _unflatten(flat_u, us), _unflatten(flat_v, us)


def momentum_correction_flat(u, v, g, alpha: float, out_dtype=None):
    """U <- alpha*U + g ; V <- V + U over a [k, ...] stack: K2 over a
    one-leaf tree. Returns (u', v')."""
    (uo,), (vo,) = momentum_correction_tree([u], [v], [g], alpha, out_dtype)
    return uo, vo


def apply_mask_flat(u, v, mask, out_dtype=None):
    """G = V*mask ; U <- U*(1-mask) ; V <- V*(1-mask), with u and v of one
    dtype and the mask of its own; the outputs are of jnp's promotion of
    the two, or of ``out_dtype`` (u's dtype: the Pallas kernel's).
    Returns (g, u', v')."""
    _check_stack("apply_mask", u, v, mask)
    _same_dtype("apply_mask", u, v)
    o = _out_dtype("apply_mask", v.dtype, mask.dtype, out_dtype)
    go, uo, vo = (torch.empty(v.shape, dtype=o, device=v.device) for _ in range(3))
    if u.numel():
        _mask_op(u, v, mask, go, uo, vo)
    return go, uo, vo


def _select_plan(name: str, plan: SelectTable, x: torch.Tensor, leaves: int) -> None:
    if not isinstance(plan, SelectTable):
        raise TypeError(f"{name}: plan must be a layout's SelectTable (layout.select_plan())")
    if (plan.n_local + plan.n_split != leaves or plan.plan.total != x.shape[1]
            or plan.table.device != x.device or plan.table.dtype != torch.int64):
        raise ValueError(f"{name}: the plan ({plan.n_local + plan.n_split} leaves, "
                         f"{plan.plan.total} elements, on {plan.table.device}) is not that of "
                         f"this stack ({leaves} leaves, {x.shape[1]} elements, on {x.device})")


def group_scratch(plan: SelectTable, rows: int) -> dict[str, int]:
    """The elements of a select's scratch buffers for ``rows`` rows:
    ``part`` (float64: the tiles' partial sums ``[rows, n_tiles, 2]``, then
    the split segments' sums ``[n_split, rows, 2]``) and ``buf`` (int32);
    in the single launch ``buf`` holds the ``[rows, n_split, 2048]``
    histograms, the ``[rows, n_split, 4]`` segment states and the grid
    barrier's two words; in the group mode three passes' ``[n_split, rows,
    2048]`` histograms, the ``[n_split, rows, GROUP_STATE_WORDS]`` states
    and each tile's candidate count ``[n_tiles, rows]``, and ``cand`` (int32)
    the candidate slots, ``rows`` times the plan's ``slots``."""
    part = rows * (plan.n_tiles + plan.n_split) * 2
    if plan.n_group is None:
        return {"part": part, "buf": rows * plan.n_split * (2048 + 4) + 2, "cand": 0}
    return {"part": part,
            "buf": rows * (plan.n_split * (3 * 2048 + GROUP_STATE_WORDS) + plan.n_tiles),
            "cand": rows * plan.slots}


def _select_scratch(plan: SelectTable, rows: int, device, stream: int):
    """The split leaves' scratch for ``rows`` rows on ``stream``
    (``group_scratch``), made once and kept on the plan, ``buf`` made zero:
    every select leaves its ticket and barrier counts zero again (and the
    single launch its histograms; the group mode zeroes them before a
    call's first pass), so calls on one stream can share it; a call whose
    launch failed drops it. Returns (partials, buffer, candidates)."""
    key = (rows, stream)
    if key not in plan.scratch:
        size = group_scratch(plan, rows)
        plan.scratch[key] = (torch.empty(size["part"], dtype=torch.float64, device=device),
                             torch.zeros(size["buf"], dtype=torch.int32, device=device),
                             torch.empty(size["cand"], dtype=torch.int32, device=device))
    return plan.scratch[key]


def _select_launch(op, plan: SelectTable, rows: int, device, *args) -> None:
    """One select launch ``op(*args, partials, buffer, ...)`` on the plan's
    scratch; a launch that failed drops the scratch."""
    stream = _stream(device)
    part, buf, _ = _select_scratch(plan, rows, device, stream)
    try:
        op(*args, part, buf)
    except RuntimeError:
        plan.scratch.pop((rows, stream), None)
        raise


def _group_select(op, plan: SelectTable, device, rows: int, group, fused: bool, head, tail, *,
                  inst: str) -> None:
    """The group mode's steps (``csrc/gmf_compress.cu``: ``launch_group_step``)
    on the current stream, ``op(step, pass, *head, partials, buffer,
    candidates, *tail)``: the first launch, (fused) the sample, the three
    radix passes, the last launch. Between them the cut segments' sums
    (fused) and each pass's histograms are all-reduced over ``group``
    (None: a group of one, nothing to sum), a segment whose piece this rank
    does not own (``plan.owners``) zeroed first. Counted as one
    ``gmf_select`` launch."""
    import torch.distributed as dist

    stream = _stream(device)
    part, buf, cand = _select_scratch(plan, rows, device, stream)
    summed = group is not None and plan.n_group > 0
    hist = rows * plan.n_split * 2048  # one pass's histograms

    def total(x, own) -> None:  # the cut segments' part of a scratch buffer, summed
        if plan.owners is not None:  # [n_group, rows, ...]: the pieces others own count 0
            x.view(plan.n_group, -1).mul_(own)
        dist.all_reduce(x, group=group)
        GROUP_SUMS[inst] = GROUP_SUMS.get(inst, 0) + 1

    def step(i: int, p: int = 0) -> None:
        try:
            op(i, p, *head, part, buf, cand, *tail)
        except RuntimeError:
            plan.scratch.pop((rows, stream), None)
            raise

    step(0)
    if fused:
        if summed:
            off = rows * plan.n_tiles * 2
            total(part[off:off + rows * plan.n_group * 2], plan.owners and plan.owners[0])
        step(1)
    for p in range(3):
        step(2, p)
        if summed:
            total(buf[p * hist:p * hist + rows * plan.n_group * 2048],
                  plan.owners and plan.owners[1])
    step(3)


def group_select_paths(plan: SelectTable, rows: int, device) -> dict[str, int]:
    """How the last group-mode select of ``rows`` rows on ``device``'s
    current stream counted its passes 1 and 2, read back from its scratch
    (a host read: for a check or a report after the call, never inside a
    select). Over the split segments of every row (``segments``, their
    ``elements``): those some tile of which read in full (``full_segments``);
    the tiles that did, as the kernel counted them (``full_tiles``) and as
    the rule gives them from the brackets and the counts
    (``full_tiles_by_rule``: the bracket missed the k-th largest's top digit,
    ``missed_tiles``, or the tile overflowed its slots, ``overflowed_tiles``)
    and their ``full_elements``; the scores the samples drew (``sampled``);
    the candidates kept (``kept``, the slots written in pass 0) and those
    that each of passes 1 and 2 read (``counted``)."""
    _, buf, _ = plan.scratch[(rows, _stream(device))]
    n_split, n_tiles = plan.n_split, plan.n_tiles
    at = 3 * rows * n_split * 2048
    state = buf[at:at + rows * n_split * GROUP_STATE_WORDS].view(n_split * rows, -1)
    state = state.to(torch.int64).cpu() & 0xFFFFFFFF
    at += rows * n_split * GROUP_STATE_WORDS
    counts = (buf[at:at + rows * n_tiles].to(torch.int64).cpu() & 0xFFFFFFFF).view(n_tiles, rows)
    first = plan.group_plan[n_split:].cpu()
    cap = (first[1:] - first[:-1]).view(n_tiles, 1)
    tiles = plan.table.cpu()[3 * plan.n_local + 2 * n_split + 1:].view(n_tiles, 5)
    rs = (tiles[:, 0].view(n_tiles, 1) * rows + torch.arange(rows)).reshape(-1)
    lo, hi, d0 = state[:, 0], state[:, 1], state[:, 3] >> 21
    missed = ~((d0 >= lo) & (d0 <= hi))[rs].view(n_tiles, rows)
    over = counts > cap
    full = missed | over
    length = tiles[:, 3].view(n_tiles, 1).expand(n_tiles, rows)
    seg_len = torch.zeros(n_split, dtype=torch.int64).index_add_(0, tiles[:, 0], tiles[:, 3])
    return {"segments": n_split * rows, "elements": int(length.sum()),
            "full_segments": int((state[:, 7] > 0).sum()), "full_tiles": int(state[:, 7].sum()),
            "full_tiles_by_rule": int(full.sum()), "missed_tiles": int(missed.sum()),
            "overflowed_tiles": int(over.sum()), "full_elements": int(length[full].sum()),
            "sampled": rows * int(seg_len.clamp(max=GROUP_SAMPLE).sum()),
            "kept": int(torch.minimum(counts, cap).sum()), "counted": int(counts[~full].sum())}


def gmf_select_flat(v, m, *, offsets, plan, keep, w, tau, eps: float, group=None):
    """Per (row, leaf) segment of the flat ``[rows, N]`` stacks v and m
    (each float32 or bfloat16, read as float32): inv_nv = w / (‖V‖ + eps),
    inv_nm = 1 / (‖M‖ + eps), and the exact
    k_i-th largest z = |((1-τ)·V)·inv_nv + (τ·M)·inv_nm| as the threshold.
    ``offsets`` (int64 ``[L + 1]``) and ``plan`` (a ``SelectTable``) come
    from the layout (``layout.select_plan()``), ``keep`` is int64 ``[L]``
    (every row's k_i) or ``[rows, L]`` (each row's own); ``w`` and ``tau``
    are ``[rows]`` float32. A segment of at most one tile is one block; a
    larger one is split over its tiles, in one launch on the current stream
    (no host read, no synchronisation), counted as one ``gmf_select``
    launch. A group mode's plan takes the group mode over ``group`` (the
    module docstring). Returns
    (inv_nv, inv_nm, thr), ``[rows, L]`` float32 each."""
    _check_stack("gmf_select", v, m)
    leaves = _segments("gmf_select", v, offsets)
    _select_plan("gmf_select", plan, v, leaves)
    rows = v.shape[0]
    stride = _keep_stride("gmf_select", keep, v, leaves)
    _check_rows("gmf_select", (rows,), v, w, tau)
    out = torch.empty(3, rows, leaves, dtype=torch.float32, device=v.device)
    inv_nv, inv_nm, thr = out
    sizes = (plan.n_local, plan.n_split, plan.n_tiles, stride, float(eps))
    if plan.n_group is not None:
        _group_select(_select_group_op, plan, v.device, rows, group, True,
                      (v, m, plan.table, keep, w, tau, out), ([*sizes[:4]], sizes[4]),
                      inst="group:" + instance(v.dtype, m.dtype))
        return inv_nv, inv_nm, thr
    _select_launch(lambda part, buf: _select_op(v, m, plan.table, keep, w, tau, inv_nv, inv_nm,
                                                thr, part, buf, *sizes),
                   plan, rows, v.device)
    return inv_nv, inv_nm, thr


def topk_abs_select_flat(z, *, offsets, plan, keep, group=None):
    """The exact k_i-th largest |z| of every (row, leaf) segment of the flat
    ``[rows, N]`` stack z and the mask |z| >= thr: ``gmf_select``'s kernel
    in its |z| mode (``plan`` and ``keep`` as there; one launch counted).
    Returns (thr ``[rows, L]``, mask ``[rows, N]``)."""
    _check_stack("gmf_select", z)
    leaves = _segments("gmf_select", z, offsets)
    _select_plan("gmf_select", plan, z, leaves)
    stride = _keep_stride("gmf_select", keep, z, leaves)
    rows = z.shape[0]
    out = torch.empty(z.numel() + rows * leaves, dtype=torch.float32, device=z.device)
    mask, thr = out[:z.numel()].view(z.shape), out[z.numel():].view(rows, leaves)
    sizes = (plan.n_local, plan.n_split, plan.n_tiles, stride)
    if plan.n_group is not None:
        _group_select(_select_abs_group_op, plan, z.device, rows, group, False,
                      (z, plan.table, keep, out), ([*sizes],),
                      inst="group:abs:" + instance(z.dtype))
        return thr, mask
    _select_launch(lambda part, buf: _select_abs_op(z, plan.table, keep, thr, mask, part, buf,
                                                    *sizes),
                   plan, rows, z.device)
    return thr, mask


def gmf_compress_flat(u, v, m, *, offsets, inv_norm_v, inv_norm_m, tau, threshold):
    """Fused GMF mask pass over flat ``[rows, N]`` stacks of the leaves
    ``offsets`` describes (at most 6,143 leaves; the kernel holds the offsets
    in 48 KB of shared memory): u and v of one dtype, which the outputs and
    the mask take, m of its own; the three per-segment scalars are
    ``[rows, L]`` float32, τ ``[rows]``. Returns (g, u', v', mask)."""
    _check_stack("gmf_compress", u, v, m)
    _same_dtype("gmf_compress", u, v)
    leaves = _segments("gmf_compress", u, offsets)
    rows = u.shape[0]
    _check_rows("gmf_compress", (rows, leaves), u, inv_norm_v, inv_norm_m, threshold)
    _check_rows("gmf_compress", (rows,), u, tau)
    go, uo, vo, mo = (torch.empty_like(v) for _ in range(4))
    if u.numel():
        _compress_op(u, v, m, inv_norm_v, inv_norm_m, threshold, tau, offsets, go, uo, vo, mo)
    return go, uo, vo, mo
