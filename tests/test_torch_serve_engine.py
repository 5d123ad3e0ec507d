"""The port's continuous-batching engine (``repro_torch.serve.engine``): the
reference's invariants (staggered arrivals token-exact against the fixed
batch, the streaming order, every wire completing, the pool drained), the
engine against JAX's ``ServeEngine`` on the same params and prompts
(tokens and every metric but the times), and its refusals.

Greedy tokens compare exactly; float32 throughout, where the port's and
JAX's logits are within 1e-5 of each other (``test_torch_serve_paged.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")

import torch_parity as tp_
from repro.configs import granite_moe_1b_a400m as jgranite
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import granite_moe_1b_a400m as tgranite
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttr
from repro_torch.serve import ServeConfig, ServeEngine
from torch_serve_parity import fixed_reference, prompts, small_configs

TIMES = {"wall_s", "tokens_per_s", "latency_p50_s", "latency_p99_s"}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = small_configs()
    jp, params = tp_.params(jcfg, seed=0)
    return jcfg, cfg, jp, params


def test_continuous_batching_token_exact_vs_fixed(small):
    """Staggered arrivals through the engine give the exact tokens of the
    all-at-once fixed batch: slot assignment, the shared pool and the
    admission order are invisible to each request's math."""
    _, cfg, _, params = small
    B, plen, gen = 3, 12, 8
    p = prompts(cfg, B, plen, seed=3)
    ref, _ = fixed_reference(cfg, params, p, gen, cache_len=64)

    scfg = ServeConfig(max_slots=2, page_size=16, pages_per_slot=4, prompt_pad=16,
                       max_new_tokens=gen, wire="float32")
    eng = ServeEngine(cfg, params, scfg)
    for i in range(B):
        eng.submit(p[i], arrival_tick=2 * i)
    comps, metrics = eng.run()

    assert [c.rid for c in comps] == list(range(B))
    assert np.array_equal(np.stack([c.tokens for c in comps]), ref)
    assert all(c.tokens.dtype == np.int32 for c in comps)
    # with 2 slots and 3 requests, request 2 waited for a slot
    assert comps[2].admit_tick > comps[1].admit_tick
    assert metrics["peak_active_slots"] == 2
    assert metrics["generated_tokens"] == B * gen
    # every page back on the free list after the drain
    assert eng.alloc.num_free == scfg.num_pages - 1
    assert not eng.alloc.live


def test_streaming_callback_order(small):
    """on_token streams each request's tokens in generation order."""
    _, cfg, _, params = small
    p = prompts(cfg, 2, 8, seed=4)
    scfg = ServeConfig(max_slots=2, page_size=8, pages_per_slot=2, prompt_pad=8,
                       max_new_tokens=4, wire="float32")
    eng = ServeEngine(cfg, params, scfg)
    for i in range(2):
        eng.submit(p[i])
    seen: dict[int, list[int]] = {0: [], 1: []}
    comps, _ = eng.run(on_token=lambda rid, t: seen[rid].append(t))
    for c in comps:
        assert seen[c.rid] == c.tokens.tolist()


@pytest.mark.parametrize("wire", ["float16", "bfloat16", "int8"])
def test_engine_compressed_wires_complete(small, wire):
    """Narrow caches serve to completion with in-vocab tokens, and a
    one-token request finishes at its admission."""
    _, cfg, _, params = small
    p = prompts(cfg, 3, 8, seed=5)
    scfg = ServeConfig(max_slots=2, page_size=8, pages_per_slot=2, prompt_pad=8,
                       max_new_tokens=4, wire=wire)
    eng = ServeEngine(cfg, params, scfg)
    for i in range(2):
        eng.submit(p[i], arrival_tick=i)
    eng.submit(p[2], max_new_tokens=1, arrival_tick=1)
    comps, metrics = eng.run()
    assert len(comps) == 3 and metrics["generated_tokens"] == 9
    for c in comps:
        assert c.tokens.shape == ((1,) if c.rid == 2 else (4,))
        assert ((0 <= c.tokens) & (c.tokens < cfg.vocab_size)).all()
    assert eng.alloc.num_free == scfg.num_pages - 1


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_engine_matches_jax_engine(small, family):
    """The same requests (lengths 5 to 16, arrivals 0, 0, 1, 3, 3, 4) through
    both engines at float32: every request's tokens, admission and
    completion ticks, and every metric but the times equal."""
    if family == "dense":
        jcfg, cfg, jp, params = small
    else:
        jcfg, cfg = tp_.configs(jgranite, tgranite, "float32")
        jp, params = tp_.params(jcfg, seed=2)
    kw = dict(max_slots=3, page_size=4, pages_per_slot=7, prompt_pad=16, max_new_tokens=6,
              wire="float32", extra_pages=2)
    jeng, eng = JServeEngine(jcfg, jp, JServeConfig(**kw)), ServeEngine(cfg, params,
                                                                        ServeConfig(**kw))
    rng = np.random.default_rng(11)
    for n, arrival, gen in ((16, 0, 6), (5, 0, 3), (11, 1, 6), (16, 3, 2), (7, 3, 6),
                            (9, 4, 5)):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        assert jeng.submit(prompt, gen, arrival) == eng.submit(prompt, gen, arrival)
    jcomps, jmetrics = jeng.run()
    comps, metrics = eng.run()
    assert [(c.rid, c.prompt_len, c.admit_tick, c.done_tick) for c in comps] == \
        [(c.rid, c.prompt_len, c.admit_tick, c.done_tick) for c in jcomps]
    for got, want in zip(comps, jcomps, strict=True):
        assert got.tokens.tolist() == np.asarray(want.tokens).tolist(), got.rid
    assert set(metrics) == set(jmetrics)
    assert {k: v for k, v in metrics.items() if k not in TIMES} == \
        {k: v for k, v in jmetrics.items() if k not in TIMES}


def test_engine_builds_its_state_where_its_params_are(small):
    _, cfg, _, params = small
    eng = ServeEngine(cfg, params, ServeConfig(prompt_pad=16))
    assert eng.device == CPU
    assert all(a.device == CPU for entry in eng.pool["groups"] for a in entry.values())


def test_engine_refuses_a_mesh(small):
    """The engine over a mesh whose model axis is over 1 (ROADMAP item 11
    part C2a; the name is older than the port and kept) lays out its pool
    by ``pool_specs``: with the int8 codec, each rank's kv heads where they
    divide the model axis and the scales cut with them; with kv heads that
    do not divide it, the pool whole. Its tokens at (1, 2) equal the
    one-rank engine's for float32 and int8 (``tests/test_torch_tp.py``);
    at model axis 1 the engine runs in ``tests/test_torch_dist_step.py``."""
    from repro_torch.dist import sharding as tshr
    from repro_torch.launch.mesh import AbstractMesh

    _, cfg, _, params = small
    mesh = AbstractMesh((1, 2), ("data", "model"))
    for kv, cut in ((cfg.num_kv_heads, cfg.num_kv_heads % 2 == 0), (1, False)):
        c = dataclasses.replace(cfg, num_kv_heads=kv)
        eng = ServeEngine(c, ttr.init_params(c, torch.Generator().manual_seed(0)),
                          ServeConfig(prompt_pad=16, wire="int8"))
        specs = tshr.pool_specs(eng.pool, mesh)
        entry, spec = eng.pool["groups"][0], specs["groups"][0]
        assert tuple(spec["k"]) == ((None, None, None, "model") if cut else ())
        assert tuple(spec["k_scale"]) == ((None, None, None, "model") if cut else ())
        assert entry["k"].shape[-2] == kv and entry["k_scale"].shape[-1] == kv


def test_engine_refuses_bad_requests_as_jax_does(small):
    jcfg, cfg, jp, params = small
    scfg = dict(page_size=8, pages_per_slot=2, prompt_pad=8, max_new_tokens=4)
    eng, jeng = ServeEngine(cfg, params, ServeConfig(**scfg)), JServeEngine(
        jcfg, jp, JServeConfig(**scfg))
    for prompt, gen in ((np.zeros(0, np.int32), None), (np.zeros(9, np.int32), None),
                        (np.zeros(8, np.int32), 9)):
        with pytest.raises(ValueError) as got:
            eng.submit(prompt, gen)
        with pytest.raises(ValueError) as want:
            jeng.submit(prompt, gen)
        assert str(got.value) == str(want.value)


def test_serve_engine_mode_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", "llama3.2-1b", "--smoke", "--mode", "engine", "--requests", "1",
                     "--prompt-len", "8", "--gen", "2"])
