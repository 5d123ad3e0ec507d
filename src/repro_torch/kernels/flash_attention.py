"""K4: forward flash attention, the port of the Pallas kernel
``repro/kernels/flash_attention.py`` (``flash_attention_bhsd``).

Two CUDA C++ kernels for ``sm_90a``, chosen by dtype and head dim alone
(``kernel_for``):

- ``"tc"``, ``csrc/flash_attention_sm90.cu``: bf16 at head dims 64, 112
  (kimi-k2), 128 and 256 (recurrentgemma-9b) on the tensor cores
  (``wgmma`` for QKᵀ and PV, TMA loads into an ``mbarrier``-guarded ring
  of K/V stages, 128-row q tiles). A row is ceil(D/64) boxes of 64
  columns; at D 112 the tensor maps declare the true D, so TMA zero-fills
  columns 112–127 on load and clips them on store, with no copy. Its
  tensor maps need 16-byte aligned storage and strides that are multiples
  of 8 elements; a bf16 input at these head dims that breaks this raises,
  it never goes to the other kernel.
- ``"cc"``, ``csrc/flash_attention.cu``: float32 at every head dim and
  bf16 at 16 and 32, on the CUDA cores in float32 (a float32 product on
  tensor cores would be TF32). One block per head and 64-row q tile, an
  online softmax in float32 registers over 64-key tiles staged in shared
  memory. It keeps its bf16 code at D 112 and 256, which ``kernel_for``
  no longer sends it.

Both skip tiles above the causal diagonal and mask ragged edges; both are
built at first use by ``kernels/build.py`` and bound by ctypes. Their
plain PyTorch version is ``kernels/ref.py:flash_attention_bhsd``.

Both wrappers go by the device of ``q``: a CUDA tensor launches a kernel
(or raises: no fallback), a CPU tensor takes the plain version. Each launch
adds one to ``LAUNCHES["flash_attention"]`` and to its kernel's own count,
``LAUNCHES["flash_attention_tc"]`` or ``LAUNCHES["flash_attention_cc"]``.

K4 is forward-only, as the Pallas kernel is (no backward kernel): both
wrappers raise, on either device, when autograd would need a gradient
through them, so that a training step cannot silently lose its gradients.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref
from repro_torch.kernels.build import BASE_FLAGS, bind, build_library

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
TC_SOURCE = CSRC / "flash_attention_sm90.cu"
NVCC_FLAGS = BASE_FLAGS
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
TC_HEAD_DIMS = (64, 112, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LOG2E = 1.4426950408889634

# Launches since the last reset_launches(), in all and per kernel: the
# evidence that a run went through the kernels.
LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0, "flash_attention_cc": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        FAKE_LAUNCHES[name] = 0


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """Which K4 kernel takes inputs of ``dtype`` at ``head_dim``: "tc" (the
    tensor-core kernel) for bf16 at the head dims of ``TC_HEAD_DIMS``, "cc"
    (CUDA cores) for float32 and for bf16 at the other head dims of
    ``HEAD_DIMS``; any other head dim raises."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {head_dim} not in {HEAD_DIMS}")
    return "tc" if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS else "cc"


def tma_layout_error(x: torch.Tensor, *, storage: bool = True) -> str | None:
    """Why the tensor-core kernel's TMA maps cannot take ``x`` (a 4-D view
    whose last dim is contiguous), or None: its storage must start 16-byte
    aligned (checked unless ``storage`` is False: the strides alone), and
    every stride of a dim longer than 1 be a multiple of 16 bytes."""
    if storage and x.data_ptr() % 16:
        return f"storage at {x.data_ptr():#x} is not 16-byte aligned"
    for size, stride in zip(x.shape[:-1], x.stride()[:-1]):
        if size > 1 and (stride * x.element_size()) % 16:
            return f"stride {stride} ({tuple(x.stride())}) is not a multiple of 16 bytes"
    return None


def build() -> Path:
    """The CUDA-core kernel's shared library, compiled first if need be."""
    return build_library(SOURCE, NVCC_FLAGS)


def build_tc() -> Path:
    """The tensor-core kernel's shared library, compiled first if need be."""
    return build_library(TC_SOURCE, NVCC_FLAGS)


_P, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (argtypes, restype) of the extern "C" functions of csrc/flash_attention.cu
# and csrc/flash_attention_sm90.cu.
SIGNATURES = {
    "flash_attention_fwd": ([_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _P,
                             _F32, _I32, _P], _I32),
}
TC_SIGNATURES = {
    "flash_attention_sm90_fwd": ([_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _P,
                                  _F32, _I32, _P], _I32),
}


@functools.cache
def library() -> ctypes.CDLL:
    return bind(ctypes.CDLL(str(build())), SIGNATURES)


@functools.cache
def library_tc() -> ctypes.CDLL:
    return bind(ctypes.CDLL(str(build_tc())), TC_SIGNATURES)


def _launch_bthd(q, k, v, o, causal: bool) -> None:
    """Launch the kernel ``kernel_for`` names over (B, T, H, D) views: q and
    o (B, T, H, D), k and v (B, S, KV, D), any strides whose last one is 1.
    The checks that read only shapes, strides and dtypes run here; the
    launch (and the storage's alignment) is the operator ``_flash_op``."""
    name = "flash_attention"
    for x in (q, k, v, o):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name}: the kernel takes tensors on one cuda device, got "
                             f"{x.device} beside {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v must share a dtype, got {x.dtype} and {q.dtype}")
        if x.stride(-1) != 1 or any(s % 4 for s in x.stride()[:-1]):
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
    if kernel_for(q.dtype, d) == "tc":
        for what, x in (("q", q), ("k", k), ("v", v), ("o", o)):
            why = tma_layout_error(x, storage=False)
            if why is not None:
                raise ValueError(f"{name}: the tensor-core kernel (bf16, D {d}) cannot take "
                                 f"{what}: {why}")
    _flash_op(q, k, v, o, causal)


# Launches traced by shape (the fake implementation, ``launch/dryrun.py``)
# since the last reset_launches(), as LAUNCHES counts the real ones.
FAKE_LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0, "flash_attention_cc": 0}


@torch.library.custom_op("repro_torch::flash_fwd_", mutates_args=("o",), device_types="cuda")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
              causal: bool) -> None:
    """K4's launch over checked (B, T, H, D) / (B, S, KV, D) views, writing
    o: the operator's CUDA implementation."""
    name = "flash_attention"
    b, t, h, d = q.shape
    _, s, kv, _ = k.shape
    kernel = kernel_for(q.dtype, d)
    for what, x in (("q", q), ("k", k), ("v", v), ("o", o)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the head dim must be contiguous, with the other "
                             f"strides multiples of 4 and 16-byte aligned storage")
        if kernel == "tc":
            why = tma_layout_error(x)
            if why is not None:
                raise ValueError(f"{name}: the tensor-core kernel (bf16, D {d}) cannot take "
                                 f"{what}: {why}")
    strides = (ctypes.c_longlong * 9)(q.stride(0), q.stride(1), q.stride(2),
                                      k.stride(0), k.stride(1), k.stride(2),
                                      o.stride(0), o.stride(1), o.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel == "tc":
            err = library_tc().flash_attention_sm90_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), d, b, h, kv, t, s,
                strides, d**-0.5 * _LOG2E, int(causal), stream)
        else:
            err = library().flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype], d,
                b, h, kv, t, s, strides, d**-0.5, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch of the {kernel} kernel failed with "
                           f"cudaError_t {err}")
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}_{kernel}"] += 1


@_flash_op.register_fake
def _(q, k, v, o, causal):
    FAKE_LAUNCHES["flash_attention"] += 1
    FAKE_LAUNCHES[f"flash_attention_{kernel_for(q.dtype, q.shape[-1])}"] += 1


@register_flop_formula(torch.ops.repro_torch.flash_fwd_)
def _flash_flops(q_shape, k_shape, v_shape, o_shape, causal, *args, out_shape=None, **kwargs):
    """K4's multiply-adds as FlopCounterMode counts a matmul: QKᵀ and PV,
    2·T·S·D each per head, half of them under the causal mask."""
    b, t, h, d = q_shape
    flops = 4 * b * h * t * k_shape[1] * d
    return flops // 2 if causal else flops


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
