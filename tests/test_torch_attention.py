"""The port's attention layers against the JAX package's, on numpy-seeded
inputs: RMSNorm, the SwiGLU MLP, RoPE, naive and chunked GQA attention,
K4's plain version against the Pallas kernel (interpret mode), the
``attention`` dispatch, and the ring-cache decode step.

Tolerances: float32 results within 1e-5 (absolute and relative): the
frameworks reduce in other orders. bfloat16 results within 3e-2: each
framework rounds its bf16 einsums itself. K4's plain version is held at
``tests/test_flash_attention.py``'s tolerances (atol 3e-5 / rtol 1e-4,
bf16 3e-2); the Pallas kernel rounds each tile's bf16 PV product to bf16
(JAX's dtype rule), the port accumulates it in float32.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import llama3_2_1b as jllama
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jatt
from repro.models import layers as jlayers
from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.kernels import flash_attention as tk4
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlayers
from repro_torch.utils.convert import from_jax_params

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
FLASH = dict(atol=3e-5, rtol=1e-4)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_mlp_rope_match(dtype):
    rng = np.random.default_rng(0)
    tol = DTYPES[dtype][2]
    jx, tx = _pair(_normal(rng, (2, 5, 32)), dtype)
    scale = {"scale": _normal(rng, (32,))}
    _close(tlayers.rmsnorm({"scale": _pair(scale["scale"], dtype)[1]}, tx, 1e-5),
           jlayers.rmsnorm({"scale": _pair(scale["scale"], dtype)[0]}, jx, 1e-5), tol)

    w = {k: _normal(rng, s, 0.2) for k, s in
         (("gate", (32, 64)), ("up", (32, 64)), ("down", (64, 32)))}
    _close(tlayers.mlp({k: _pair(v, dtype)[1] for k, v in w.items()}, tx),
           jlayers.mlp({k: _pair(v, dtype)[0] for k, v in w.items()}, jx), tol)

    jq, tq = _pair(_normal(rng, (2, 7, 4, 16)), dtype)
    pos = np.array([[0, 1, 2, 3, 500, 1000, 2047], [5, 6, 7, 8, 9, 10, 11]])
    _close(tlayers.apply_rope(tq, torch.from_numpy(pos), 500_000.0),
           jlayers.apply_rope(jq, jnp.asarray(pos), 500_000.0), tol)


def _qkv(rng, b, t, h, kv, d, s=None):
    s = s or t
    return _normal(rng, (b, t, h, d)), _normal(rng, (b, s, kv, d)), _normal(rng, (b, s, kv, d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 24])
def test_naive_and_chunked_match(dtype, window):
    rng = np.random.default_rng(1)
    tol = DTYPES[dtype][2]
    arrays = _qkv(rng, 2, 64, 8, 2, 16)
    j = [_pair(a, dtype)[0] for a in arrays]
    t = [_pair(a, dtype)[1] for a in arrays]
    _close(tatt.naive_causal_attention(*t, window=window),
           jatt.naive_causal_attention(*j, window=window), tol)
    _close(tatt.chunked_causal_attention(*t, chunk=16, window=window),
           jatt.chunked_causal_attention(*j, chunk=16, window=window), tol)


def test_naive_right_aligns_queries_against_a_longer_key_run():
    rng = np.random.default_rng(2)
    arrays = _qkv(rng, 1, 5, 4, 2, 16, s=12)
    _close(tatt.naive_causal_attention(*(torch.from_numpy(a) for a in arrays)),
           jatt.naive_causal_attention(*(jnp.asarray(a) for a in arrays)), F32)


@pytest.mark.parametrize(
    "b,t,h,kv,d,bq,bk",
    [
        (2, 128, 4, 2, 32, 64, 64),
        (1, 256, 8, 8, 64, 128, 64),   # MHA
        (2, 64, 4, 1, 16, 32, 32),     # MQA
        (1, 128, 6, 2, 32, 32, 64),    # uneven blocks
    ],
)
def test_k4_plain_matches_pallas(b, t, h, kv, d, bq, bk):
    arrays = _qkv(np.random.default_rng(t + h), b, t, h, kv, d)
    want = jflash(*(jnp.asarray(a) for a in arrays), block_q=bq, block_k=bk)
    got = tk4.flash_attention(*(torch.from_numpy(a) for a in arrays))
    _close(got, want, FLASH)


def test_k4_plain_matches_pallas_noncausal():
    arrays = _qkv(np.random.default_rng(3), 1, 64, 2, 2, 16)
    want = jflash(*(jnp.asarray(a) for a in arrays), block_q=32, block_k=32, causal=False)
    got = tk4.flash_attention(*(torch.from_numpy(a) for a in arrays), causal=False)
    _close(got, want, FLASH)


def test_k4_plain_matches_pallas_bf16():
    arrays = _qkv(np.random.default_rng(4), 1, 128, 4, 2, 32)
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in arrays), block_q=64, block_k=64)
    got = tk4.flash_attention(*(torch.from_numpy(a).bfloat16() for a in arrays))
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)


@pytest.mark.parametrize("t", [1, 37, 100, 130])
def test_k4_plain_takes_any_length(t):
    """T that is no tile multiple (the Pallas kernel refuses these), held
    against JAX's naive attention; bhsd and bthd wrappers agree."""
    arrays = _qkv(np.random.default_rng(t), 2, t, 8, 2, 32)
    want = jatt.naive_causal_attention(*(jnp.asarray(a) for a in arrays))
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = tk4.flash_attention(q, k, v)
    _close(got, want, FLASH)
    bhsd = tk4.flash_attention_bhsd(q.transpose(1, 2).reshape(16, t, 32),
                                    k.transpose(1, 2).reshape(4, t, 32),
                                    v.transpose(1, 2).reshape(4, t, 32))
    assert torch.equal(bhsd.reshape(2, 8, t, 32).transpose(1, 2), got)


def _cfg():
    return tllama.smoke(), jllama.smoke()


def _attn_params(rng, jcfg):
    params = jatt.init_attention(jax.random.PRNGKey(int(rng.integers(1 << 30))), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, from_jax_params(np_params, layout="transformer")


def test_attention_dispatch_on_cpu():
    tcfg, jcfg = _cfg()
    rng = np.random.default_rng(5)
    jp, tp = _attn_params(rng, jcfg)
    x = _normal(rng, (2, 48, tcfg.d_model))
    q = torch.zeros(1, 48, 8, 32)
    assert tatt.resolve_impl("auto", tcfg, q, q, q, 0) == "naive"
    assert tatt.resolve_impl("auto", tcfg, q, q[:, :47], q[:, :47], 0) == "naive"
    long_cfg = dataclasses.replace(tcfg, attn_chunk=512)
    kv = torch.zeros(1, 4096, 2, 32)
    assert tatt.resolve_impl("auto", long_cfg, torch.zeros(1, 4096, 8, 32), kv, kv,
                             0) == "chunked"
    want, (wk, wv) = jatt.attention(jp, jcfg, jnp.asarray(x))
    for impl in ("auto", "naive", "flash"):
        got, (k, v) = tatt.attention(tp, tcfg, torch.from_numpy(x), impl=impl)
        _close(got, want, F32)
        _close(k, wk, F32)
        _close(v, wv, F32)
    with pytest.raises(ValueError, match="window"):
        tatt.attention(tp, tcfg, torch.from_numpy(x), impl="flash", window=16)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_over_a_wrapping_ring(window):
    """Eleven steps through a ring of 4 slots: the ring wraps twice and the
    validity mask must still pick the right positions."""
    tcfg, jcfg = _cfg()
    rng = np.random.default_rng(6)
    jp, tp = _attn_params(rng, jcfg)
    cache_len, b = 4, 2
    jcache = jatt.init_kv_cache(jcfg, b, cache_len, jnp.float32)
    tcache = tatt.init_kv_cache(tcfg, b, cache_len, torch.float32, "cpu")
    for pos in range(11):
        x = _normal(rng, (b, tcfg.d_model))
        want, jcache = jatt.decode_attention(jp, jcfg, jcache, jnp.asarray(x), pos,
                                             window=window)
        got, tcache = tatt.decode_attention(tp, tcfg, tcache, torch.from_numpy(x),
                                            torch.tensor(pos), window=window)
        _close(got, want, F32)
        _close(tcache["k"], jcache["k"], F32)
        _close(tcache["v"], jcache["v"], F32)


@pytest.mark.parametrize("wrapper", ["bthd", "bhsd"])
def test_k4_refuses_a_gradient(wrapper):
    """K4 is forward-only: asked for a gradient it raises (on any device),
    rather than hand back an output that autograd cannot reach through."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(6), 1, 16, 4, 2, 16))
    if wrapper == "bhsd":
        q, k, v = (x.transpose(1, 2).reshape(-1, 16, 16) for x in (q, k, v))
    fn = tk4.flash_attention if wrapper == "bthd" else tk4.flash_attention_bhsd
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(q, k, v.requires_grad_())
    with torch.no_grad():
        assert fn(q, k, v).shape == q.shape


def test_attention_takes_no_flash_for_training():
    """With a gradient asked through q/k/v, ``auto`` does not resolve to K4,
    and an explicit ``flash`` raises instead of dropping the gradient."""
    tcfg, jcfg = _cfg()
    rng = np.random.default_rng(7)
    _, tp = _attn_params(rng, jcfg)
    x = torch.from_numpy(_normal(rng, (1, 16, tcfg.d_model))).requires_grad_()
    q = torch.zeros(1, 16, 8, 32)
    assert tatt.resolve_impl("auto", tcfg, q, q, q.clone().requires_grad_(), 0) == "naive"
    out, _ = tatt.attention(tp, tcfg, x)
    out.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    with pytest.raises(RuntimeError, match="forward-only"):
        tatt.attention(tp, tcfg, x, impl="flash")
