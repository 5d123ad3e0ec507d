"""Build, binding and launch of the CUDA compression kernels.

The kernels live in ``csrc/gmf_compress.cu`` behind a plain C interface,
built at first use by ``kernels/build.py`` (nvcc for ``sm_90a``, loaded
with ctypes). Nothing is built when this module is imported.

Each ``*_flat`` wrapper takes ``[k, ...]`` float32 CUDA tensors (one row
per client), checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if
the launch failed, and adds one to its count in ``LAUNCHES``. There is no
fallback: a tensor the kernel does not take raises.

K1 and its glue take the flat compression state (``utils/flat.py``): a
``[k, N]`` stack of L leaf segments, described by the layout's int64
offsets ``[L + 1]`` on the device and a keep count per segment: an int64
``[L]`` array shared by every row (a fixed rate) or a ``[k, L]`` table of
per-client counts (adaptive rates), read with a row stride of 0 or L.
``gmf_select_flat`` (one block per segment) gives each segment's inverse
norms and exact top-k threshold, ``[k, L]`` each, and ``gmf_compress_flat``
is the fused mask pass over the whole stack; ``topk_abs_select_flat`` is
the same select on ``|z|`` with the mask, for DGC's top-k. Both select
modes count as ``gmf_select`` launches. K3 (``apply_mask_flat``) takes any
stack, the flat one included.

K2 (``momentum_correction_tree``) is one multi-tensor launch over every
leaf of a tree: ``plan_momentum`` cuts the leaves into launches of at most
the table's capacity and gives each leaf its first block,
``momentum_table`` packs each launch's table, and
``momentum_correction_flat`` is the same call over a one-leaf tree.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.build import BASE_FLAGS, bind, build_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "gmf_compress.cu"
# -fmad=false: K1's z must be bitwise the z its threshold was taken from.
NVCC_FLAGS = (*BASE_FLAGS, "-fmad=false")

# Launches per kernel since the last reset_launches(): the evidence that a
# run went through the kernels.
LAUNCHES = {"gmf_select": 0, "gmf_compress": 0, "momentum_correction": 0, "apply_mask": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> Path:
    """The shared library's path, compiled first if need be."""
    return build_library(SOURCE, NVCC_FLAGS)


_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# (argtypes, restype) of every extern "C" function of csrc/gmf_compress.cu.
SIGNATURES = {
    "gmf_momentum_limits": ([_P, _P], None),
    "gmf_momentum_multi": ([_P, _I32, _I32, _F32, _P], _I32),
    "gmf_apply_mask": ([_P, _P, _P, _P, _P, _P, _I64, _I32, _P], _I32),
    "gmf_select": ([_P, _P, _P, _P, _I32, _P, _P, _F32, _I32, _I64, _I64, _P, _P, _P, _P],
                   _I32),
    "gmf_select_abs": ([_P, _P, _P, _I32, _I32, _I64, _I64, _P, _P, _P], _I32),
    "gmf_compress": ([_P] * 8 + [_I32, _I64] + [_P] * 4 + [_I64, _I32, _P], _I32),
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


def _check_stack(name: str, *xs: torch.Tensor) -> None:
    ref = xs[0]
    if ref.dim() < 1:
        raise ValueError(f"{name}: operands need a leading client axis, got a 0-dim tensor")
    for x in xs:
        if not x.is_cuda or x.device != ref.device:
            raise ValueError(f"{name}: the kernel takes tensors on one cuda device, got "
                             f"{x.device} beside {ref.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")
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


def _vec(*xs: torch.Tensor) -> int:
    return int(all(x.data_ptr() % 16 == 0 for x in xs))


def _launch(name: str, fn, device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    LAUNCHES[name] += 1


class MomentumTable(NamedTuple):
    uo: list        # u' leaves: views into one flat buffer, leaf after leaf
    vo: list        # v' leaves, likewise
    launches: list  # (table, leaves, blocks) per launch; the table is [leaves, 8]
    #                 int64: u, v, g, u', v', n, first block, aligned


def momentum_table(us, vs, gs, capacity: int, chunk: int) -> MomentumTable:
    """The host half of K2 over lists of leaves, on any device: checks one
    device, float32, contiguity and matching shapes; allocates u' and v' as
    views into one flat buffer each; and packs each launch of
    ``plan_momentum`` into the int64 table the C entry point reads. The
    alignment flag is 1 where all five pointers of a leaf are 16-byte
    aligned. The host work is a pass over the leaves per step and numpy
    columns, with no allocation per leaf but the output views."""
    name = "momentum_correction"
    if not (len(us) == len(vs) == len(gs)):
        raise ValueError(f"{name}: {len(us)}, {len(vs)}, {len(gs)} leaves")
    device, f32 = us[0].device, torch.float32
    if any(x.dtype is not f32 or not x.is_contiguous() or x.device != device
           for xs in (us, vs, gs) for x in xs):
        raise ValueError(f"{name}: the kernel takes contiguous float32 tensors on {device}")
    shapes = [u.shape for u in us]
    if shapes != [v.shape for v in vs] or shapes != [g.shape for g in gs]:
        raise ValueError(f"{name}: u, v and g leaves differ in shape")
    sizes = [u.numel() for u in us]
    flat_u = torch.empty(sum(sizes), dtype=f32, device=device)
    flat_v = torch.empty_like(flat_u)
    uo, vo = _unflatten(flat_u, us), _unflatten(flat_v, us)
    table = np.empty((len(us), 8), dtype=np.int64)
    for col, xs in enumerate((us, vs, gs)):
        table[:, col] = [x.data_ptr() for x in xs]
    table[:, 5] = sizes
    starts = 4 * (np.cumsum(table[:, 5]) - table[:, 5])
    table[:, 3] = flat_u.data_ptr() + starts
    table[:, 4] = flat_v.data_ptr() + starts
    table[:, 7] = np.bitwise_or.reduce(table[:, :5], axis=1) % 16 == 0
    launches = []
    for launch in plan_momentum(sizes, capacity, chunk):
        rows = table if len(launch.leaves) == len(us) else table[list(launch.leaves)]
        rows[:, 6] = launch.block0
        launches.append((rows, len(launch.leaves), launch.blocks))
    return MomentumTable(uo, vo, launches)


def _unflatten(flat, like):
    """Views of ``flat`` shaped like the tensors ``like``, one after the
    other (torch's own C++ split, as distributed data parallel uses)."""
    return torch._C._nn.unflatten_dense_tensors(flat, like)


def launch_momentum(table: MomentumTable, alpha: float, device) -> None:
    """K2's launches of ``table`` on ``device``'s current stream."""
    for leaves, count, blocks in table.launches:
        _launch("momentum_correction", library().gmf_momentum_multi, device,
                leaves.ctypes.data, count, blocks, float(alpha))


def momentum_correction_tree(us, vs, gs, alpha: float):
    """U <- alpha*U + g ; V <- V + U over lists of leaves on one cuda
    device (``momentum_table`` says what it takes), one launch per table's
    capacity of leaves. Returns (u' list, v' list)."""
    if not us:
        return [], []
    device = us[0].device
    if device.type != "cuda":
        raise ValueError(f"momentum_correction: the kernel takes cuda tensors, got {device}")
    table = momentum_table(us, vs, gs, *momentum_limits())
    launch_momentum(table, alpha, device)
    return table.uo, table.vo


def momentum_correction_flat(u, v, g, alpha: float):
    """U <- alpha*U + g ; V <- V + U over a [k, ...] stack: K2 over a
    one-leaf tree. Returns (u', v')."""
    (uo,), (vo,) = momentum_correction_tree([u], [v], [g], alpha)
    return uo, vo


def apply_mask_flat(u, v, mask):
    """G = V*mask ; U <- U*(1-mask) ; V <- V*(1-mask). Returns (g, u', v')."""
    _check_stack("apply_mask", u, v, mask)
    go, uo, vo = torch.empty_like(v), torch.empty_like(u), torch.empty_like(v)
    if u.numel():
        _launch("apply_mask", library().gmf_apply_mask, u.device,
                u.data_ptr(), v.data_ptr(), mask.data_ptr(), go.data_ptr(), uo.data_ptr(),
                vo.data_ptr(), u.numel(), _vec(u, v, mask, go, uo, vo))
    return go, uo, vo


def gmf_select_flat(v, m, *, offsets, keep, w, tau, eps: float):
    """Per (row, leaf) segment of the flat ``[rows, N]`` stacks v and m:
    inv_nv = w / (‖V‖ + eps), inv_nm = 1 / (‖M‖ + eps), and the exact
    k_i-th largest z = |((1-τ)·V)·inv_nv + (τ·M)·inv_nm| as the threshold.
    ``offsets`` (int64 ``[L + 1]``) comes from the layout, ``keep`` is
    int64 ``[L]`` (every row's k_i) or ``[rows, L]`` (each row's own);
    ``w`` and ``tau`` are ``[rows]`` float32. Returns (inv_nv, inv_nm,
    thr), ``[rows, L]`` float32 each."""
    _check_stack("gmf_select", v, m)
    leaves = _segments("gmf_select", v, offsets)
    rows = v.shape[0]
    stride = _keep_stride("gmf_select", keep, v, leaves)
    _check_rows("gmf_select", (rows,), v, w, tau)
    inv_nv, inv_nm, thr = (torch.empty(rows, leaves, dtype=torch.float32, device=v.device)
                           for _ in range(3))
    _launch("gmf_select", library().gmf_select, v.device, v.data_ptr(), m.data_ptr(),
            offsets.data_ptr(), keep.data_ptr(), stride, w.data_ptr(), tau.data_ptr(),
            float(eps), leaves, rows, v.shape[1], inv_nv.data_ptr(), inv_nm.data_ptr(),
            thr.data_ptr())
    return inv_nv, inv_nm, thr


def topk_abs_select_flat(z, *, offsets, keep):
    """The exact k_i-th largest |z| of every (row, leaf) segment of the flat
    ``[rows, N]`` stack z and the mask |z| >= thr: ``gmf_select``'s kernel
    in its |z| mode (``keep`` as there). Returns (thr ``[rows, L]``, mask
    ``[rows, N]``)."""
    _check_stack("gmf_select", z)
    leaves = _segments("gmf_select", z, offsets)
    stride = _keep_stride("gmf_select", keep, z, leaves)
    thr = torch.empty(z.shape[0], leaves, dtype=torch.float32, device=z.device)
    mask = torch.empty_like(z)
    _launch("gmf_select", library().gmf_select_abs, z.device, z.data_ptr(), offsets.data_ptr(),
            keep.data_ptr(), stride, leaves, z.shape[0], z.shape[1], thr.data_ptr(),
            mask.data_ptr())
    return thr, mask


def gmf_compress_flat(u, v, m, *, offsets, inv_norm_v, inv_norm_m, tau, threshold):
    """Fused GMF mask pass over flat ``[rows, N]`` stacks of the leaves
    ``offsets`` describes (at most 6,143 leaves; the kernel holds the offsets
    in 48 KB of shared memory): the three per-segment scalars are
    ``[rows, L]`` float32, τ ``[rows]``. Returns (g, u', v', mask)."""
    _check_stack("gmf_compress", u, v, m)
    leaves = _segments("gmf_compress", u, offsets)
    rows = u.shape[0]
    _check_rows("gmf_compress", (rows, leaves), u, inv_norm_v, inv_norm_m, threshold)
    _check_rows("gmf_compress", (rows,), u, tau)
    go, uo, vo, mo = (torch.empty_like(v) for _ in range(4))
    if u.numel():
        _launch("gmf_compress", library().gmf_compress, u.device,
                u.data_ptr(), v.data_ptr(), m.data_ptr(), inv_norm_v.data_ptr(),
                inv_norm_m.data_ptr(), threshold.data_ptr(), tau.data_ptr(), offsets.data_ptr(),
                leaves, u.shape[1], go.data_ptr(), uo.data_ptr(), vo.data_ptr(), mo.data_ptr(),
                u.numel(), _vec(u, v, m, go, uo, vo, mo))
    return go, uo, vo, mo
