"""K4: forward flash attention, the port of the Pallas kernel
``repro/kernels/flash_attention.py`` (``flash_attention_bhsd``).

The kernel is CUDA C++ for ``sm_90a`` in ``csrc/flash_attention.cu``
(one thread block per head and 64-row query tile, an online softmax in
float32 registers over 64-key tiles staged in shared memory, tiles above
the causal diagonal skipped, ragged edges masked), built at first use by
``kernels/build.py`` and bound by ctypes. Its plain PyTorch version is
``kernels/ref.py:flash_attention_bhsd``.

Both wrappers go by the device of ``q``: a CUDA tensor launches the kernel
(or raises: no fallback), a CPU tensor takes the plain version. Each launch
adds one to ``LAUNCHES["flash_attention"]``.

K4 is forward-only, as the Pallas kernel is (no backward kernel): both
wrappers raise, on either device, when autograd would need a gradient
through them, so that a training step cannot silently lose its gradients.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import BASE_FLAGS, build_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NVCC_FLAGS = BASE_FLAGS
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches since the last reset_launches(): the evidence that a run went
# through the kernel.
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def build() -> Path:
    """The shared library's path, compiled first if need be."""
    return build_library(SOURCE, NVCC_FLAGS)


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i32, i32, i32, i32, i32, i32, i32, p,
                                        ctypes.c_float, i32, p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _launch_bthd(q, k, v, o, causal: bool) -> None:
    """Launch over (B, T, H, D) views: q and o (B, T, H, D), k and v
    (B, S, KV, D), any strides whose last one is 1."""
    name = "flash_attention"
    for x in (q, k, v, o):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name}: the kernel takes tensors on one cuda device, got "
                             f"{x.device} beside {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v must share a dtype, got {x.dtype} and {q.dtype}")
        if x.stride(-1) != 1 or any(s % 4 for s in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(f"{name}: the head dim must be contiguous, with the other "
                             f"strides multiples of 4 and 16-byte aligned storage")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {q.dtype}")
    b, t, h, d = q.shape
    _, s, kv, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv
            or k.stride() != v.stride() or o.shape != q.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not (B,T,H,D), (B,S,KV,D), (B,S,KV,D) "
                         f"with H a multiple of KV and k, v laid out alike")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if s == 0:
        raise ValueError(f"{name}: no keys (S = 0)")
    if b * h > 65535:
        raise ValueError(f"{name}: B*H = {b * h} exceeds the grid's 65535")
    if t == 0:
        return
    strides = (ctypes.c_longlong * 9)(q.stride(0), q.stride(1), q.stride(2),
                                      k.stride(0), k.stride(1), k.stride(2),
                                      o.stride(0), o.stride(1), o.stride(2))
    with torch.cuda.device(q.device):
        err = library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype], d,
            b, h, kv, t, s, strides, d**-0.5, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    LAUNCHES[name] += 1


def _forward_only(q, k, v) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash_attention: K4 is forward-only (no backward kernel) but "
                           "q, k or v requires grad; run it under torch.no_grad() or use "
                           "the 'naive' or 'chunked' attention")


def _on_card(q: torch.Tensor) -> bool:
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"no flash-attention kernel for tensors on {q.device}")


def flash_attention_bhsd(q, k, v, *, causal: bool = True):
    """q: (BH, T, D); k/v: (BKV, S, D) with BH = BKV·G (query head i reads
    kv head i // G). Returns o: (BH, T, D) in q's dtype."""
    _forward_only(q, k, v)
    if not _on_card(q):
        return ref.flash_attention_bhsd(q, k, v, causal=causal)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    # (BH, T, D) is (B=1, T, H=BH, D) through strides: no copy.
    _launch_bthd(*(x.unsqueeze(0).transpose(1, 2) for x in (q, k, v, o)), causal)
    return o


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, T, H, D); k/v: (B, S, KV, D) — GQA-aware flash attention.
    Returns (B, T, H, D) in q's dtype."""
    _forward_only(q, k, v)
    if not _on_card(q):
        return ref.flash_attention(q, k, v, causal=causal)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch_bthd(q, k, v, o, causal)
    return o
