"""K4 at the head dims the remaining configs use: 112 (kimi-k2-1t-a32b, H 64
/ KV 8) and 256 (recurrentgemma-9b, H 16 / KV 1, i.e. MQA), on the CPU.

The kernel's plain version (``repro_torch.kernels.ref``, what the wrapper
runs for a CPU tensor) is held against the JAX package's
``naive_causal_attention`` at GQA G 8 and MQA, and, where T divides the
block sizes, against the Pallas kernel in interpret mode (as
``tests/test_flash_attention.py`` runs it). Tolerances: float32 within
1e-5 relative (max |port − JAX| ≤ 1e-5 × max |JAX|; the two sum in other
orders), bfloat16 within 3e-2 absolute and relative (the Pallas kernel
rounds each tile's bf16 PV product, the port accumulates it in float32).

The wrapper-level checks that run here: ``kernel_for`` sends bf16 at D
112 and 256 to the tensor-core kernel and float32 there to the CUDA-core
kernel; zero-padding D 112 to 128 at the scale 112^-0.5 (the tensor-core
kernel's premise) keeps the function; an unsupported head dim still
raises; and ``attention(impl="auto")`` resolves a window that masks
nothing to K4 (the hybrid family's serving prefill) but not one that
masks keys.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jatt
from repro_torch.configs import kimi_k2_1t_a32b, recurrentgemma_9b
from repro_torch.kernels import flash_attention as tk4
from repro_torch.kernels import ref
from repro_torch.models import attention as tatt

REL = 1e-5
BF16 = dict(atol=3e-2, rtol=3e-2)


def _qkv(seed, b, t, h, kv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, n, d)).astype(np.float32) for n in (h, kv, kv))


def _rel(got, want):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("d", [112, 256])
@pytest.mark.parametrize("h, kv", [(16, 2), (16, 1)], ids=["G8", "MQA"])
@pytest.mark.parametrize("t", [1, 64, 100])
def test_k4_plain_matches_naive_at_new_head_dims(d, h, kv, t):
    arrays = _qkv(d + t + kv, 2, t, h, kv, d)
    want = jatt.naive_causal_attention(*(jnp.asarray(a) for a in arrays))
    got = ref.flash_attention(*(torch.from_numpy(a) for a in arrays))
    assert _rel(got, want) <= REL
    # the wrapper takes the plain version for CPU tensors and launches nothing
    tk4.reset_launches()
    assert torch.equal(tk4.flash_attention(*(torch.from_numpy(a) for a in arrays)), got)
    assert tk4.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("d", [112, 256])
@pytest.mark.parametrize("h, kv", [(8, 1), (16, 2)], ids=["MQA", "G8"])
@pytest.mark.parametrize("causal", [True, False])
def test_k4_plain_matches_pallas_at_new_head_dims(d, h, kv, causal):
    arrays = _qkv(d + h, 1, 128, h, kv, d)
    want = jflash(*(jnp.asarray(a) for a in arrays), block_q=64, block_k=64, causal=causal)
    got = ref.flash_attention(*(torch.from_numpy(a) for a in arrays), causal=causal)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("d", [112, 256])
def test_k4_plain_matches_pallas_bf16_at_new_head_dims(d):
    arrays = _qkv(d, 1, 128, 8, 1, d)
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in arrays), block_q=64, block_k=64)
    got = ref.flash_attention(*(torch.from_numpy(a).bfloat16() for a in arrays))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [112, 256])
def test_k4_new_head_dims_go_to_the_cuda_core_kernel(dtype, d):
    """float32 at D 112 and 256 stays on the CUDA-core kernel (a float32
    product on tensor cores would be TF32); bf16 there goes to the
    tensor-core kernel."""
    assert d in tk4.HEAD_DIMS
    assert tk4.kernel_for(dtype, d) == ("tc" if dtype == torch.bfloat16 else "cc")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [1, 64, 200])
def test_k4_zero_padding_112_to_128_keeps_the_function(causal, t):
    """The tensor-core kernel's premise at D 112: q, k and v zero-padded to
    128 columns (what TMA's fill gives it), scored at 112^-0.5, give the
    D 112 function in the first 112 output columns and exact zeros in the
    last 16. Plain float32 arithmetic on the CPU (one softmax over all
    keys) against the plain K4 (64-key tiles, an online softmax), within
    1e-6 relative L2: the two sum in other orders (~6e-7 at T 200)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(t + causal, 2, t, 8, 2, 112))
    want = ref.flash_attention(q, k, v, causal=causal)
    qp, kp, vp = (torch.nn.functional.pad(x, (0, 16)) for x in (q, k, v))
    kp, vp = (x.repeat_interleave(4, dim=2) for x in (kp, vp))  # G 4
    sc = torch.einsum("bthd,bshd->bhts", qp, kp) * 112**-0.5
    if causal:
        sc = sc.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), -torch.inf)
    got = torch.einsum("bhts,bshd->bthd", torch.softmax(sc, dim=-1), vp)
    assert got.shape == (2, t, 8, 128)
    assert torch.equal(got[..., 112:], torch.zeros(2, t, 8, 16))
    assert float((got[..., :112] - want).norm() / want.norm()) <= 1e-6


@pytest.mark.parametrize("d", [8, 48, 96, 192, 512])
def test_k4_unsupported_head_dim_raises(d):
    with pytest.raises(ValueError, match="head dim"):
        tk4.kernel_for(torch.bfloat16, d)
    q = torch.zeros(1, 4, 2, d)
    with pytest.raises(ValueError, match="head dim|cuda"):
        tk4._launch_bthd(q, q, q, torch.empty_like(q), True)


def test_config_head_dims_are_kernel_head_dims():
    assert kimi_k2_1t_a32b.CONFIG.head_dim == 112
    assert recurrentgemma_9b.CONFIG.head_dim == 256
    assert recurrentgemma_9b.CONFIG.num_kv_heads == 1


@pytest.mark.parametrize("window, t, want", [(0, 48, True), (48, 48, True), (64, 48, True),
                                             (47, 48, False), (16, 48, False)])
def test_a_window_that_masks_nothing_is_no_window(window, t, want):
    assert tatt.covers(window, t) is want
    # on the CPU, auto never picks flash; an explicit flash checks the window
    q = torch.zeros(1, t, 4, 16)
    cfg = recurrentgemma_9b.smoke()
    assert tatt.resolve_impl("auto", cfg, q, q, q, window) == "naive"


def test_flash_takes_a_covering_window_and_refuses_a_masking_one():
    cfg = recurrentgemma_9b.smoke()
    gen = torch.Generator().manual_seed(0)
    params = tatt.init_attention(gen, cfg)
    x = torch.randn(2, 48, cfg.d_model, generator=gen)
    want, _ = tatt.attention(params, cfg, x, impl="naive", window=0)
    got, _ = tatt.attention(params, cfg, x, impl="flash", window=48)
    assert _rel(got, want.numpy()) <= REL
    with pytest.raises(ValueError, match="window"):
        tatt.attention(params, cfg, x, impl="flash", window=47)
