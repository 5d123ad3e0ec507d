"""The port's paged KV storage (``repro_torch.serve.cache``): codecs, pools,
the block allocator and ``ServeConfig``, on their own (the reference's
``tests/test_serve.py`` invariants) and against the JAX package's on the
same inputs.

Exact throughout: a codec's stored bytes (int8 values and scales
included) and its gather, pool byte counts and the allocator's pages are
elementwise or counting work, so they must equal JAX's bit for bit. Inputs
stay in float32's normal range (ROADMAP R4: XLA's CPU backend flushes
subnormal results to zero, torch does not).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_smoke as jget_smoke
from repro.serve import ServeConfig as JServeConfig
from repro.serve import cache as jcache
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.serve import (
    BlockAllocator,
    ServeConfig,
    bytes_per_page,
    init_pool,
    make_kv_codec,
    pool_bytes,
)
from repro_torch.serve.cache import SCRATCH_PAGE
from torch_serve_parity import small_configs

WIRES = ("float32", "float16", "bfloat16", "int8")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cfgs():
    return small_configs()


def _np(x) -> np.ndarray:
    """A leaf's bytes as a numpy array of its dtype (bf16 as uint16 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


# ---------------------------------------------------------------------------
# allocator
# ---------------------------------------------------------------------------


def test_allocator_never_aliases_live_pages():
    alloc = BlockAllocator(17)  # 16 usable pages
    a = alloc.alloc(5)
    b = alloc.alloc(7)
    assert SCRATCH_PAGE not in a + b
    assert len(set(a) | set(b)) == 12  # disjoint
    alloc.free(a)
    c = alloc.alloc(9)  # reuses a's pages, must still not alias b
    assert not set(c) & set(b)
    assert alloc.live == set(b) | set(c)


def test_allocator_rejects_bad_frees_and_exhaustion():
    alloc = BlockAllocator(5)
    pages = alloc.alloc(4)
    with pytest.raises(RuntimeError, match="out of KV pages"):
        alloc.alloc(1)  # exhausted
    alloc.free(pages[:1])
    with pytest.raises(RuntimeError, match="invalid free"):
        alloc.free(pages[:1])  # double free
    with pytest.raises(RuntimeError, match="invalid free"):
        alloc.free([SCRATCH_PAGE])  # scratch is never freeable
    with pytest.raises(RuntimeError, match="invalid free"):
        alloc.free([99])  # never allocated
    with pytest.raises(ValueError, match="non-scratch"):
        BlockAllocator(1)


def test_allocator_hands_out_jax_pages():
    """The same alloc/free calls return the same pages, in the same order,
    with the same free counts and high-water mark."""
    calls = [("alloc", 3), ("alloc", 5), ("free", 0), ("alloc", 2), ("alloc", 4),
             ("free", 1), ("free", 3), ("alloc", 6), ("alloc", 1), ("free", 2)]
    got, want = BlockAllocator(20), jcache.BlockAllocator(20)
    held = {id(got): [], id(want): []}
    for op, arg in calls:
        for a in (got, want):
            if op == "alloc":
                held[id(a)].append(a.alloc(arg))
            else:
                a.free(held[id(a)][arg])
        assert held[id(got)] == held[id(want)]
        assert (got.num_free, got.num_live, got.peak_live, got.live) == \
            (want.num_free, want.num_live, want.peak_live, want.live)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


def test_int8_cache_roundtrip_error_bounded(cfgs):
    """Per-(page slot, kv head) symmetric int8: |x − decode(encode(x))| ≤
    max|x|/254 per vector; the scratch page decodes to exact zeros."""
    _, cfg = cfgs
    codec = make_kv_codec("int8", cfg)
    entry = codec.init_entry(num_pages=3, page_size=4, device=CPU)
    gen = torch.Generator().manual_seed(6)
    k = torch.randn((2, 4, cfg.num_kv_heads, cfg.head_dim), generator=gen)
    v = torch.randn(k.shape, generator=gen)
    entry = codec.write_pages(entry, k, v, torch.tensor([1, 2]))
    k_hat, v_hat = codec.gather(entry, torch.tensor([[1, 2]]))
    for x, x_hat in ((k, k_hat), (v, v_hat)):
        flat = x.reshape(1, 8, cfg.num_kv_heads, cfg.head_dim)
        bound = flat.abs().amax(dim=-1, keepdim=True) / 254.0 + 1e-7
        assert bool(((x_hat - flat).abs() <= bound).all())
    z_k, _ = codec.gather(entry, torch.zeros((1, 2), dtype=torch.int64))
    assert bool((z_k == 0.0).all())


def test_float32_codec_roundtrips_exact_bytes(cfgs):
    _, cfg = cfgs
    codec = make_kv_codec("float32", cfg)
    entry = codec.init_entry(num_pages=2, page_size=4, device=CPU)
    gen = torch.Generator().manual_seed(8)
    k = torch.randn((4, cfg.num_kv_heads, cfg.head_dim), generator=gen)
    v = torch.randn(k.shape, generator=gen)
    entry = codec.write_token(entry, k, v, torch.tensor([1] * 4), torch.arange(4))
    k_hat, v_hat = codec.gather(entry, torch.tensor([[1]]))
    assert torch.equal(k_hat[0], k) and torch.equal(v_hat[0], v)


def test_make_kv_codec_rejects_an_unknown_wire(cfgs):
    jcfg, cfg = cfgs
    with pytest.raises(ValueError) as got:
        make_kv_codec("probquant", cfg)
    with pytest.raises(ValueError) as want:
        jcache.make_kv_codec("probquant", jcfg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("wire", WIRES)
def test_codec_bytes_and_gather_equal_jax(cfgs, wire):
    """Whole pages (a prefill) then single tokens (decode steps, the
    scratch page among the targets) written into one entry in both
    packages: every stored leaf bitwise, the gather too."""
    jcfg, cfg = cfgs
    rng = np.random.default_rng(3)
    shape = (cfg.num_kv_heads, cfg.head_dim)
    kp, vp = (rng.normal(size=(3, 4, *shape)).astype(np.float32) for _ in range(2))
    kt, vt = (rng.normal(size=(3, *shape)).astype(np.float32) for _ in range(2))
    kt[1, 0] = 0.0  # an all-zero vector: int8 scale 0
    pages, phys, offset = np.array([4, 1, 3]), np.array([2, 0, 4]), np.array([1, 3, 0])
    tables = np.array([[4, 1, 3, 2], [0, 2, 0, 4]])

    jc = jcache.make_kv_codec(wire, jcfg)
    je = jc.init_entry(5, 4)
    je = jc.write_pages(je, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages))
    je = jc.write_token(je, jnp.asarray(kt), jnp.asarray(vt), jnp.asarray(phys),
                        jnp.asarray(offset))
    tc = make_kv_codec(wire, cfg)
    te = tc.init_entry(5, 4, device=CPU)
    te = tc.write_pages(te, torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(pages))
    te = tc.write_token(te, torch.from_numpy(kt), torch.from_numpy(vt), torch.from_numpy(phys),
                        torch.from_numpy(offset))
    assert sorted(te) == sorted(je)
    for key in je:
        assert str(te[key].dtype).split(".")[1] == str(je[key].dtype), key
        assert np.array_equal(_np(te[key]), _np(je[key])), key
    for got, want in zip(tc.gather(te, torch.from_numpy(tables)),
                         jc.gather(je, jnp.asarray(tables)), strict=True):
        assert tuple(got.shape) == want.shape
        assert np.array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------


def test_pool_bytes_ordering(cfgs):
    """Capacity accounting: int8 < bfloat16 < float32 pool footprints, with
    int8 at least 3x smaller than float32."""
    _, cfg = cfgs
    sizes = {wire: pool_bytes(init_pool(cfg, make_kv_codec(wire, cfg), 9, 8, device=CPU))
             for wire in ("float32", "bfloat16", "int8")}
    assert sizes["int8"] < sizes["bfloat16"] < sizes["float32"]
    assert sizes["float32"] / sizes["bfloat16"] == 2.0
    assert sizes["float32"] / sizes["int8"] >= 3.0


def _configs(name):
    if name == "small":
        return small_configs()
    return jget_smoke(name), tget_smoke(name)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("name", ["small", "llama3.2-1b", "granite-moe-1b-a400m"])
def test_pool_bytes_and_structure_equal_jax(name, wire):
    jcfg, cfg = _configs(name)
    jpool = jcache.init_pool(jcfg, jcache.make_kv_codec(wire, jcfg), 9, 8)
    pool = init_pool(cfg, make_kv_codec(wire, cfg), 9, 8, device=CPU)
    assert pool_bytes(pool) == jcache.pool_bytes(jpool)
    assert bytes_per_page(pool, 9) == jcache.bytes_per_page(jpool, 9)
    for part in ("groups", "tail"):
        assert len(pool[part]) == len(jpool[part])
        for got, want in zip(pool[part], jpool[part], strict=True):
            assert {k: tuple(a.shape) for k, a in got.items()} == \
                {k: a.shape for k, a in want.items()}
            assert all(bool((a == 0).all()) and a.device == CPU for a in got.values())


def test_pool_rejects_unsupported_family(cfgs):
    _, cfg = cfgs
    ssm = dataclasses.replace(cfg, name="ssm-test", family="ssm", ssm_state=16)
    with pytest.raises(ValueError, match="paged serving"):
        init_pool(ssm, make_kv_codec("float32", ssm), 5, 8, device=CPU)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b", "qwen2-vl-72b",
                                  "musicgen-large"])
def test_pool_refuses_jax_s_families_with_its_text(arch):
    jcfg, cfg = jget_smoke(arch), tget_smoke(arch)
    with pytest.raises(ValueError) as want:
        jcache.init_pool(jcfg, jcache.make_kv_codec("float32", jcfg), 5, 8)
    with pytest.raises(ValueError) as got:
        init_pool(cfg, make_kv_codec("float32", cfg), 5, 8, device=CPU)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# ServeConfig
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(wire="probquant"), dict(prompt_pad=20), dict(pages_per_slot=1, prompt_pad=32),
    dict(max_slots=0), dict(max_new_tokens=0),
])
def test_serve_config_refuses_as_jax_does(kw):
    with pytest.raises(ValueError) as want:
        JServeConfig(**kw)
    with pytest.raises(ValueError) as got:
        ServeConfig(**kw)
    assert str(got.value) == str(want.value)


def test_serve_config_capacity_equals_jax():
    for kw in ({}, dict(max_slots=3, pages_per_slot=5, extra_pages=2, page_size=8,
                        prompt_pad=16)):
        got, want = ServeConfig(**kw), JServeConfig(**kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.slot_capacity, got.num_pages) == (want.slot_capacity, want.num_pages)
