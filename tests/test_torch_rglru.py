"""The port's RG-LRU block (``repro_torch.models.rglru``) and the hybrid
family (recurrentgemma-9b's ``smoke()``: rec, rec, attn and a tail) against
the JAX package's, on JAX-initialised params converted leaf for leaf and
numpy-seeded inputs.

Tolerances: per tensor, max |port − JAX| ≤ REL × max |JAX|, REL 1e-5 in
float32 and 3e-2 in bfloat16 (``tests/torch_parity.py``). The doubling
scan (``rglru_scan``) associates the products in another order than
``jax.lax.associative_scan``: it is held within 2e-6 relative of it in
float32 over 300 steps, and within 2e-6 relative of a float64 sequential
loop. The reference's invariants (the block equals its stepwise
recurrence, the decay lies strictly inside (0, 1), prefill → decode
equals the full forward) hold within its 1e-4.

ROADMAP R10, the reference-side fact the port copies: a forward with no
window in its ctx attends the hybrid family's attention blocks unwindowed
(``local_attn_window`` sizes only ``init_cache``), so its prefill cache is
``cache_len`` long; the serving steps pass ``window = local_attn_window``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import torch_parity as tp_
from repro.configs import recurrentgemma_9b as jrg
from repro.configs.base import ModelConfig as JConfig
from repro.dist import step as jstep
from repro.models import rglru as jrglru
from repro.models import transformer as jtr
from repro_torch.configs import recurrentgemma_9b as trg
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.dist import step as tstep
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttr
from repro_torch.utils import tree_leaves
from repro_torch.utils.convert import from_jax_params

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(name="h", family="hybrid", num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
             d_ff=64, vocab_size=10, block_pattern=("rec",), lru_width=32)
SCAN_REL = 2e-6


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _pair(a, dtype):
    jd, td = DT[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _block(dtype, seed=4):
    cfg = dict(SMALL)
    if dtype != "float32":
        cfg.update(dtype=dtype, param_dtype=dtype)
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                                           layout="transformer")


def test_gates_match():
    _, _, jp, tp = _block("float32")
    u = _normal(np.random.default_rng(0), (2, 7, 32), 3.0)
    ja, jb = jrglru._gates(jp, jnp.asarray(u))
    ta, tb = trglru._gates(tp, torch.from_numpy(u))
    assert ta.dtype == tb.dtype == torch.float32
    assert tp_.rel_err(ta, ja) <= 1e-5 and tp_.rel_err(tb, jb) <= 1e-5


def _sequential64(a, b, h0):
    h = np.zeros(a.shape, np.float64)
    prev = h0.astype(np.float64) if h0 is not None else np.zeros(a[:, 0].shape)
    for t in range(a.shape[1]):
        prev = a[:, t].astype(np.float64) * prev + b[:, t]
        h[:, t] = prev
    return h


@pytest.mark.parametrize("t", [1, 2, 5, 64, 300])
@pytest.mark.parametrize("with_h0", [False, True])
def test_doubling_scan_matches_associative_scan_and_the_recurrence(t, with_h0):
    rng = np.random.default_rng(t)
    a = rng.uniform(0.5, 0.999, size=(2, t, 16)).astype(np.float32)
    b = _normal(rng, (2, t, 16))
    h0 = _normal(rng, (2, 16)) if with_h0 else None
    got = trglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                            None if h0 is None else torch.from_numpy(h0))
    want = jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                             None if h0 is None else jnp.asarray(h0))
    assert got.dtype == torch.float32
    assert tp_.rel_err(got, want) <= SCAN_REL
    assert tp_.rel_err(got, _sequential64(a, b, h0)) <= SCAN_REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [16, 2])  # longer and shorter than the conv
def test_block_forward_and_decode_step_match(dtype, t):
    jcfg, tcfg, jp, tp = _block(dtype)
    rng = np.random.default_rng(t)
    jx, tx = _pair(_normal(rng, (2, t, 32), 0.5), dtype)
    want_y, (want_h, want_tail) = jrglru.rglru_block_forward(jp, jcfg, jx)
    got_y, (got_h, got_tail) = trglru.rglru_block_forward(tp, tcfg, tx)
    assert tp_.rel_err(got_y, want_y) <= tp_.REL[dtype]
    assert tp_.rel_err(got_h, want_h) <= tp_.REL[dtype]
    assert tuple(got_tail.shape) == want_tail.shape
    assert tp_.rel_err(got_tail, want_tail) <= tp_.REL[dtype]
    jxt, txt = _pair(_normal(rng, (2, 32), 0.5), dtype)
    jy, jc = jrglru.rglru_decode_step(jp, jcfg, {"state": want_h, "conv": want_tail}, jxt)
    ty, tc = trglru.rglru_decode_step(tp, tcfg, {"state": got_h, "conv": got_tail}, txt)
    assert tp_.rel_err(ty, jy) <= tp_.REL[dtype]
    assert tp_.rel_err(tc["state"], jc["state"]) <= tp_.REL[dtype]
    assert tp_.rel_err(tc["conv"], jc["conv"]) <= tp_.REL[dtype]


def test_rglru_matches_stepwise():
    _, cfg, _, p = _block("float32")
    x = torch.from_numpy(_normal(np.random.default_rng(5), (2, 16, 32), 0.5))
    y_full, (h_last, _) = trglru.rglru_block_forward(p, cfg, x)
    cache = trglru.init_rglru_cache(cfg, 2, torch.float32, "cpu")
    ys = []
    for t in range(16):
        y_t, cache = trglru.rglru_decode_step(p, cfg, cache, x[:, t])
        ys.append(y_t)
    np.testing.assert_allclose(y_full.numpy(), torch.stack(ys, 1).numpy(), atol=1e-4)
    np.testing.assert_allclose(h_last.numpy(), cache["state"].numpy(), atol=1e-4)


def test_rglru_decay_bounded():
    """RG-LRU gate a ∈ (0, 1) ⇒ stable recurrence."""
    cfg = TConfig(**dict(SMALL, d_model=16, lru_width=16))
    p = trglru.init_rglru_block(torch.Generator().manual_seed(5), cfg)
    u = torch.from_numpy(_normal(np.random.default_rng(6), (4, 8, 16), 3.0))
    a, _ = trglru._gates(p, u)
    assert float(a.min()) > 0.0 and float(a.max()) < 1.0


def test_gelu_is_the_tanh_approximation():
    _, tcfg, jp, tp = _block("float32")
    x = _normal(np.random.default_rng(7), (1, 4, 32), 4.0)
    want = jax.nn.gelu(jnp.asarray(x) @ jp["gate_proj"])
    got = torch.nn.functional.gelu(torch.from_numpy(x) @ tp["gate_proj"], approximate="tanh")
    exact = torch.nn.functional.gelu(torch.from_numpy(x) @ tp["gate_proj"])
    assert tp_.rel_err(got, want) <= 1e-6 < tp_.rel_err(exact, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_family_forward_prefill_decode_match(dtype):
    jcfg, tcfg = tp_.configs(jrg, trg, dtype)
    jp, tp = tp_.params(jcfg)
    jb, tb = tp_.prompts(jcfg, 2, 24)
    tp_.check_forward(jcfg, tcfg, jp, tp, jb, tb, dtype)
    # decode runs past the local window (64): the ring wraps
    jb, tb = tp_.prompts(jcfg, 2, 60, seed=1)
    tp_.check_prefill_decode(jcfg, tcfg, jp, tp, jb, tb, dtype, prompt_len=60, gen=8,
                             cache_len=68)


def test_hybrid_prefill_then_decode_equals_forward():
    _, tcfg = tp_.configs(jrg, trg, "float32")
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(1))
    _, tb = tp_.prompts(tcfg, 2, 24, seed=3)
    tp_.check_prefill_then_decode_equals_forward(tcfg, params, tb, 20, 4)


def test_r10_prefill_longer_than_the_local_window():
    """ROADMAP R10: a forward with no window in its ctx attends unwindowed
    and keeps a ``cache_len`` attention cache, although ``init_cache``
    sizes it at the local window; the port's shapes and logits equal the
    JAX package's. Through the serving prefill (window = local window) the
    cache is the window's length on both sides."""
    jcfg, tcfg = tp_.configs(jrg, trg, "float32")
    assert tcfg.local_attn_window == 64 and tcfg.sliding_window == 0
    jp, tp = tp_.params(jcfg)
    jb, tb = tp_.prompts(jcfg, 1, 100, seed=4)
    ctx = {"want_cache": True, "cache_len": 128}
    want, _, jcache = jtr.forward(jcfg, jp, jb, ctx=ctx)
    with torch.no_grad():
        got, _, tcache = ttr.forward(tcfg, tp, tb, ctx=ctx)
    assert tp_.rel_err(got, want) <= tp_.REL["float32"]
    shapes = [tuple(x.shape) for x in tree_leaves(tcache)]
    assert shapes == [x.shape for x in jax.tree_util.tree_leaves(jcache)]
    attn = tcache["groups"][2]
    assert tuple(attn["k"].shape) == tuple(attn["v"].shape) == (1, 1, 128, 1, 64)
    for g, w in zip(tree_leaves(tcache), jax.tree_util.tree_leaves(jcache), strict=True):
        assert tp_.rel_err(g, w) <= tp_.REL["float32"]
    init = ttr.init_cache(tcfg, 1, 128, device="cpu")
    assert tuple(init["groups"][2]["k"].shape) == (1, 1, 64, 1, 64)
    assert [x.shape for x in jax.tree_util.tree_leaves(jtr.init_cache(jcfg, 1, 128))] == \
        [tuple(x.shape) for x in tree_leaves(init)]
    # the serving prefill windows the attention and its cache
    jlast, jserve_cache = jstep.make_prefill_step(jcfg, cache_len=128)(jp, jb)
    tlast, tserve_cache = tstep.make_prefill_step(tcfg, cache_len=128)(tp, tb)
    assert tp_.rel_err(tlast, jlast) <= tp_.REL["float32"]
    assert tuple(tserve_cache["groups"][2]["k"].shape) == (1, 1, 64, 1, 64)
    assert tp_.rel_err(tlast, got[:, -1]) > 1e-3  # the window changes the answer


def test_hybrid_decode_cache_is_written_in_place_and_keeps_its_shapes():
    cfg = trg.smoke()
    params = ttr.init_params(cfg, torch.Generator().manual_seed(2))
    prefill = tstep.make_prefill_step(cfg, cache_len=40)
    serve = tstep.make_serve_step(cfg)
    last, cache = prefill(params, {"tokens": torch.randint(0, cfg.vocab_size, (2, 30))})
    before = [(x.data_ptr(), tuple(x.shape)) for x in tree_leaves(cache)]
    states = [x.clone() for x in tree_leaves(cache)]
    tok = torch.argmax(last, dim=-1)
    for pos in range(30, 34):
        tok, _, out = serve(params, cache, tok, torch.tensor(pos))
        assert out is cache
    assert [(x.data_ptr(), tuple(x.shape)) for x in tree_leaves(cache)] == before
    assert all(not torch.equal(a, b) for a, b in zip(states, tree_leaves(cache), strict=True))


def test_hybrid_config_pattern_and_tail():
    cfg = trg.CONFIG
    pattern, n_groups, tail = ttr.pattern_info(cfg)
    assert pattern == ("rec", "rec", "attn") and n_groups == 12 and tail == ("rec", "rec")
    assert ttr.pattern_info(trg.smoke()) == (("rec", "rec", "attn"), 1, ("rec", "rec"))
