"""Build, binding and launch of the CUDA compression kernels.

The kernels live in ``csrc/gmf_compress.cu`` behind a plain C interface,
built at first use by ``kernels/build.py`` (nvcc for ``sm_90a``, loaded
with ctypes). Nothing is built when this module is imported.

Each ``*_flat`` wrapper takes ``[k, ...]`` float32 CUDA tensors (one row
per client), checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if
the launch failed, and adds one to its count in ``LAUNCHES``. There is no
fallback: a tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BASE_FLAGS, build_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "gmf_compress.cu"
# -fmad=false: K1's z must be bitwise the z its threshold was taken from.
NVCC_FLAGS = (*BASE_FLAGS, "-fmad=false")

# Launches per kernel since the last reset_launches(): the evidence that a
# run went through the kernels.
LAUNCHES = {"gmf_compress": 0, "momentum_correction": 0, "apply_mask": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> Path:
    """The shared library's path, compiled first if need be."""
    return build_library(SOURCE, NVCC_FLAGS)


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gmf_momentum.argtypes = [p, p, p, p, p, i64, ctypes.c_float, i32, p]
    lib.gmf_apply_mask.argtypes = [p, p, p, p, p, p, i64, i32, p]
    lib.gmf_compress.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i64, i64, i32, p]
    for fn in (lib.gmf_momentum, lib.gmf_apply_mask, lib.gmf_compress):
        fn.restype = ctypes.c_int
    return lib


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


def _check_rows(name: str, rows: int, like: torch.Tensor, *scalars: torch.Tensor) -> None:
    for s in scalars:
        if (not s.is_cuda or s.device != like.device or s.dtype != torch.float32
                or s.shape != (rows,) or not s.is_contiguous()):
            raise ValueError(
                f"{name}: per-row scalars must be contiguous float32 [{rows}] tensors on "
                f"{like.device}, got {s.dtype} {tuple(s.shape)} on {s.device}")


def _vec(*xs: torch.Tensor) -> int:
    return int(all(x.data_ptr() % 16 == 0 for x in xs))


def _launch(name: str, fn, device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    LAUNCHES[name] += 1


def momentum_correction_flat(u, v, g, alpha: float):
    """U <- alpha*U + g ; V <- V + U over a [k, ...] stack. Returns (u', v')."""
    _check_stack("momentum_correction", u, v, g)
    uo, vo = torch.empty_like(u), torch.empty_like(v)
    if u.numel():
        _launch("momentum_correction", library().gmf_momentum, u.device,
                u.data_ptr(), v.data_ptr(), g.data_ptr(), uo.data_ptr(), vo.data_ptr(),
                u.numel(), float(alpha), _vec(u, v, g, uo, vo))
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


def gmf_compress_flat(u, v, m, *, inv_norm_v, inv_norm_m, tau, threshold):
    """Fused GMF pass over a [k, ...] stack; the four scalars are [k]
    float32 CUDA tensors, one per client row. Returns (g, u', v', mask)."""
    _check_stack("gmf_compress", u, v, m)
    rows = u.shape[0]
    _check_rows("gmf_compress", rows, u, inv_norm_v, inv_norm_m, threshold, tau)
    go, uo, vo, mo = (torch.empty_like(v) for _ in range(4))
    if u.numel():
        _launch("gmf_compress", library().gmf_compress, u.device,
                u.data_ptr(), v.data_ptr(), m.data_ptr(), inv_norm_v.data_ptr(),
                inv_norm_m.data_ptr(), threshold.data_ptr(), tau.data_ptr(),
                go.data_ptr(), uo.data_ptr(), vo.data_ptr(), mo.data_ptr(),
                u.numel(), u.numel() // rows, _vec(u, v, m, go, uo, vo, mo))
    return go, uo, vo, mo
