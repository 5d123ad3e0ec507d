"""The port's paged decode (``models.attention.paged_decode_attention``) and
paged serving steps (``dist.step.make_paged_prefill_step`` /
``make_paged_serve_step``): the reference's determinism anchors held in
the port, then the port against the JAX package on the same params,
tables and tokens.

Tolerances: the float32 paged decode is **bitwise** the port's own ring
cache (the float32 codec stores the ring's bytes; masked positions are
exact softmax zeros). Against JAX, max |port − JAX| ≤ 1e-5 × max |JAX|
per tensor (``tests/torch_parity.py``'s float32 REL: the two frameworks
sum matrix products in other orders), greedy tokens equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import torch_parity as tp_
from repro.dist import step as jstep
from repro.models import attention as jattn
from repro.serve import cache as jcache
from repro_torch.dist import step as tstep
from repro_torch.models import attention as tattn
from repro_torch.serve import init_pool, make_kv_codec
from torch_serve_parity import fixed_reference, prompts, small_configs

REL = tp_.REL["float32"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = small_configs()
    jp, params = tp_.params(jcfg, seed=0)
    return jcfg, cfg, jp, params


# ---------------------------------------------------------------------------
# the reference's anchors, in the port
# ---------------------------------------------------------------------------


def test_paged_float32_matches_ring_bitwise(small):
    """Same prompt, same positions, equal attention extents: the prefill's
    and every decode step's logits are byte-identical between the ring
    cache and the paged pool, over a page table that is not in order."""
    _, cfg, _, params = small
    page_size, pages = 8, 4
    plen, gen = 16, 6
    cap = page_size * pages  # == the ring's cache_len, so the softmax extents match
    p = prompts(cfg, 1, plen, seed=1)
    ref_toks, ref_logits = fixed_reference(cfg, params, p, gen, cap)

    codec = make_kv_codec("float32", cfg)
    pool = init_pool(cfg, codec, 1 + pages, page_size, device=CPU)
    table = torch.tensor([[3, 1, 4, 2]])
    prefill = tstep.make_paged_prefill_step(cfg, codec, prompt_pad=plen)
    step = tstep.make_paged_serve_step(cfg, codec)

    tok, last, pool = prefill(params, torch.from_numpy(p).long(), pool, table[0], plen)
    assert torch.equal(last, ref_logits[0])
    lengths = torch.tensor([plen])
    for i in range(gen - 1):
        tok, lg, pool = step(params, pool, table, lengths, tok)
        assert torch.equal(lg, ref_logits[i + 1]), f"step {i}"
        lengths = lengths + 1
        assert int(tok[0]) == ref_toks[0, i + 1]


def test_prefill_last_index_ignores_padding(small):
    """Right-padding the prompt to the fixed shape does not change the true
    last token's greedy token (causal masking + the last_index slice)."""
    _, cfg, _, params = small
    plen, pad = 10, 16
    p = prompts(cfg, 1, plen, seed=2)
    ref, ref_logits = fixed_reference(cfg, params, p, 1, 32)

    codec = make_kv_codec("float32", cfg)
    pool = init_pool(cfg, codec, 1 + 4, 8, device=CPU)
    prefill = tstep.make_paged_prefill_step(cfg, codec, prompt_pad=pad)
    padded = np.zeros((1, pad), np.int64)
    padded[0, :plen] = p
    tok, last, _ = prefill(params, torch.from_numpy(padded), pool, torch.arange(1, 5),
                           torch.tensor(plen))
    assert int(tok[0]) == ref[0, 0]
    assert tp_.rel_err(last, ref_logits[0].numpy()) <= REL


def test_paged_steps_record_no_autograd(small):
    _, cfg, _, params = small
    live = {k: v for k, v in params.items()}
    live["final_norm"] = {k: v.clone().requires_grad_(True)
                          for k, v in params["final_norm"].items()}
    codec = make_kv_codec("float32", cfg)
    pool = init_pool(cfg, codec, 3, 8, device=CPU)
    tok, last, pool = tstep.make_paged_prefill_step(cfg, codec, prompt_pad=8)(
        live, torch.zeros((1, 8), dtype=torch.int64), pool, torch.tensor([1, 2]), 8)
    nxt, lg, _ = tstep.make_paged_serve_step(cfg, codec)(
        live, pool, torch.tensor([[1, 2]]), torch.tensor([8]), tok)
    assert not last.requires_grad and not lg.requires_grad


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 8])
def test_paged_decode_attention_matches_jax(small, window):
    """One layer's paged decode over 3 slots at positions 2, 13 and 26 (the
    window cuts the last two), one slot's table pointing into the scratch
    page: the output, and the entry with the new tokens written, within
    REL of JAX's."""
    jcfg, cfg, jp, params = small
    rng = np.random.default_rng(5)
    shape = (7, 8, cfg.num_kv_heads, cfg.head_dim)  # 7 pages of 8
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
    pos = np.array([2, 13, 26])
    tables = np.array([[5, 0, 0, 0], [2, 6, 0, 0], [1, 3, 4, 6]])
    jattn_p = jax.tree_util.tree_map(lambda a: a[0], jp["layers"][0]["attn"])
    tattn_p = {key: a[0] for key, a in params["layers"][0]["attn"].items()}

    jc = jcache.make_kv_codec("float32", jcfg)
    want, jentry = jattn.paged_decode_attention(
        jattn_p, jcfg, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(x),
        jnp.asarray(pos), tables=jnp.asarray(tables), codec=jc, window=window)
    tc = make_kv_codec("float32", cfg)
    entry = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    got, got_entry = tattn.paged_decode_attention(
        tattn_p, cfg, entry, torch.from_numpy(x), torch.from_numpy(pos),
        tables=torch.from_numpy(tables), codec=tc, window=window)
    assert got_entry is entry  # written in place
    assert tp_.rel_err(got, want) <= REL
    for key in ("k", "v"):
        assert tp_.rel_err(entry[key], jentry[key]) <= REL
        changed = np.any(np.asarray(jentry[key]) != (k if key == "k" else v), axis=(2, 3))
        assert np.array_equal(np.argwhere(changed), [[5, 2], [6, 2], [6, 5]])


@pytest.mark.parametrize("window", [0, 8])
def test_paged_steps_match_jax(window):
    """Two requests prefilled into scrambled pages of one pool, then 6
    decode steps over 3 slots (one idle: length 0, scratch row), to
    position 13 (past the window of 8): prefill
    and step logits within REL of JAX's, greedy tokens equal, and the pool
    within REL after the run."""
    jcfg, cfg = small_configs(sliding_window=window)
    jp, params = tp_.params(jcfg, seed=4)
    # the prompt pad stays within the window: a prefill's cache keeps only
    # the last `window` tokens, in the reference as in the port
    page_size, pad = 4, 8
    tables = np.array([[7, 2, 9, 4, 12, 1], [3, 10, 5, 11, 6, 8], [0, 0, 0, 0, 0, 0]])
    lens = [8, 5]
    p = prompts(cfg, 2, pad, seed=7)
    p[1, lens[1]:] = 0

    jcodec = jcache.make_kv_codec("float32", jcfg)
    jpool = jcache.init_pool(jcfg, jcodec, 13, page_size)
    jprefill = jax.jit(jstep.make_paged_prefill_step(jcfg, jcodec, prompt_pad=pad))
    jserve = jax.jit(jstep.make_paged_serve_step(jcfg, jcodec))
    codec = make_kv_codec("float32", cfg)
    pool = init_pool(cfg, codec, 13, page_size, device=CPU)
    prefill = tstep.make_paged_prefill_step(cfg, codec, prompt_pad=pad)
    serve = tstep.make_paged_serve_step(cfg, codec)

    jtok, ttok = np.zeros(3, np.int32), torch.zeros(3, dtype=torch.int64)
    for i, n in enumerate(lens):
        jt, jlast, jpool = jprefill(jp, jnp.asarray(p[i:i + 1]), jpool,
                                    jnp.asarray(tables[i], jnp.int32), np.int32(n))
        tt, tlast, pool = prefill(params, torch.from_numpy(p[i:i + 1]).long(), pool,
                                  torch.from_numpy(tables[i]), n)
        assert tp_.rel_err(tlast, jlast) <= REL
        assert int(tt[0]) == int(jt[0])
        jtok[i], ttok[i] = int(jt[0]), tt[0]
    jtok = jnp.asarray(jtok)
    jlens = jnp.asarray(lens + [0], jnp.int32)
    tlens = torch.tensor(lens + [0])
    active = torch.tensor([1, 1, 0])
    for step in range(6):
        jtok, jlogits, jpool = jserve(jp, jpool, jnp.asarray(tables, jnp.int32), jlens, jtok)
        ttok, tlogits, pool = serve(params, pool, torch.from_numpy(tables), tlens, ttok)
        assert tp_.rel_err(tlogits[:2], jlogits[:2]) <= REL, f"step {step}"
        assert ttok[:2].tolist() == np.asarray(jtok)[:2].tolist(), f"step {step}"
        jlens = jlens + jnp.asarray([1, 1, 0], jnp.int32)
        tlens = tlens + active
    for got, want in zip(pool["groups"][0].values(), jpool["groups"][0].values(), strict=True):
        live = np.asarray(sorted(set(tables[:2].ravel())))  # the scratch page holds garbage
        assert tp_.rel_err(got[:, live], np.asarray(want)[:, live]) <= REL


def test_paged_decode_takes_the_window_from_the_config(small):
    """``window=None`` is ``cfg.sliding_window``, as in the ring decode."""
    _, cfg, _, params = small
    win = dataclasses.replace(cfg, sliding_window=4)
    rng = np.random.default_rng(9)
    entry = {key: torch.from_numpy(rng.normal(size=(3, 8, 2, 16)).astype(np.float32))
             for key in ("k", "v")}
    attn_p = {key: a[0] for key, a in params["layers"][0]["attn"].items()}
    x = torch.from_numpy(rng.normal(size=(1, cfg.d_model)).astype(np.float32))
    codec = make_kv_codec("float32", cfg)
    kw = dict(tables=torch.tensor([[2, 1]]), codec=codec)
    a, _ = tattn.paged_decode_attention(attn_p, win, {k: t.clone() for k, t in entry.items()},
                                        x, torch.tensor([11]), **kw)
    b, _ = tattn.paged_decode_attention(attn_p, win, {k: t.clone() for k, t in entry.items()},
                                        x, torch.tensor([11]), window=4, **kw)
    c, _ = tattn.paged_decode_attention(attn_p, win, {k: t.clone() for k, t in entry.items()},
                                        x, torch.tensor([11]), window=0, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
