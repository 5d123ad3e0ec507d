"""The vlm family (qwen2-vl-72b's ``smoke()``: patch embeddings prepended,
M-RoPE) and the audio family (musicgen-large's: four codebooks summed in,
a (K, d, V) unembedding, (B, K) decode tokens) of the port against the JAX
package's, on JAX-initialised params converted leaf for leaf and
numpy-seeded prompts; ``apply_mrope`` alone; the serving entry point on
both.

Tolerances: per tensor, max |port − JAX| ≤ REL × max |JAX|, REL 1e-5 in
float32 and 3e-2 in bfloat16 (``tests/torch_parity.py``); the reference's
invariants (M-RoPE at text positions is RoPE, prefill → decode equals the
full forward) within 1e-5 and 1e-4.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import torch_parity as tp_
from repro.configs import musicgen_large as jmusic
from repro.configs import qwen2_vl_72b as jvl
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro_torch.configs import musicgen_large as tmusic
from repro_torch.configs import qwen2_vl_72b as tvl
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.utils import tree_leaves

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FAMILIES = {"vlm": (jvl, tvl), "audio": (jmusic, tmusic)}
TIMES = {"prefill_ms", "decode_ms", "ms_per_step", "tokens_per_s"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections", [(4, 6, 6), (16, 24, 24)])
def test_apply_mrope_matches(dtype, sections):
    rng = np.random.default_rng(sum(sections))
    d = 2 * sum(sections)
    x = rng.normal(size=(2, 9, 3, d)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 9)).astype(np.int32)  # distinct t, h, w ids
    jd, td = DT[dtype]
    want = jlayers.apply_mrope(jnp.asarray(x, jd), jnp.asarray(pos), 1e6, sections)
    got = tlayers.apply_mrope(torch.from_numpy(x).to(td), torch.from_numpy(pos).long(), 1e6,
                              sections)
    assert got.dtype == td
    assert tp_.rel_err(got, want) <= tp_.REL[dtype]


def test_mrope_text_positions_match_rope():
    """For text tokens (t = h = w position), M-RoPE is plain RoPE."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 12, 2, 16)).astype(np.float32))
    pos = torch.arange(12).expand(1, 12)
    plain = tlayers.apply_rope(x, pos, 10_000.0)
    mr = tlayers.apply_mrope(x, pos.expand(3, 1, 12), 10_000.0, (4, 2, 2))
    np.testing.assert_allclose(plain.numpy(), mr.numpy(), atol=1e-5)


def test_mrope_sections_must_cover_half_the_head_dim():
    with pytest.raises(ValueError, match="sections"):
        tlayers.apply_mrope(torch.zeros(1, 2, 1, 16), torch.zeros(3, 1, 2), 1e4, (4, 2, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_forward_prefill_decode_match(family, dtype):
    jm, tm = FAMILIES[family]
    jcfg, tcfg = tp_.configs(jm, tm, dtype)
    jp, tp = tp_.params(jcfg)
    jb, tb = tp_.prompts(jcfg, 2, 20)
    logits = tp_.check_forward(jcfg, tcfg, jp, tp, jb, tb, dtype)
    if family == "audio":
        assert tuple(logits.shape) == (2, tcfg.num_codebooks, 20, tcfg.vocab_size)
    else:
        assert tuple(logits.shape) == (2, tcfg.num_patches + 20, tcfg.vocab_size)
    # vlm: the serving cache holds prompt_len + gen slots, fewer than the
    # patches and prompt together, so the ring has wrapped at the first step
    tp_.check_prefill_decode(jcfg, tcfg, jp, tp, jb, tb, dtype, prompt_len=20, gen=6,
                             cache_len=26)


def test_vlm_explicit_mrope_positions_match():
    jcfg, tcfg = tp_.configs(jvl, tvl, "float32")
    jp, tp = tp_.params(jcfg)
    jb, tb = tp_.prompts(jcfg, 2, 8)
    t = tcfg.num_patches + 8
    pos = np.random.default_rng(1).integers(0, 40, (3, 2, t)).astype(np.int32)
    jb["mrope_positions"], tb["mrope_positions"] = jnp.asarray(pos), torch.from_numpy(pos).long()
    tp_.check_forward(jcfg, tcfg, jp, tp, jb, tb, "float32")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_then_decode_equals_forward(family):
    _, tcfg = tp_.configs(*FAMILIES[family], "float32")
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(1))
    _, tb = tp_.prompts(tcfg, 2, 24, seed=3)
    tp_.check_prefill_then_decode_equals_forward(tcfg, params, tb, 20, 4)


def test_audio_multicodebook_shapes():
    cfg = TConfig(name="a", family="audio", num_layers=2, d_model=64, num_heads=4,
                  num_kv_heads=4, d_ff=128, vocab_size=50, num_codebooks=4)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    assert tuple(params["embed"]["table"].shape) == (4, 50, 64)
    assert tuple(params["unembed"]["kernel"].shape) == (4, 64, 50)
    assert sum(x.numel() for x in tree_leaves(params)) == cfg.param_count()
    with torch.no_grad():
        logits, _, _ = ttr.forward(cfg, params, {"tokens": torch.randint(0, 50, (2, 4, 16))})
        assert tuple(logits.shape) == (2, 4, 16, 50)
        cache = ttr.init_cache(cfg, 2, 32, device="cpu")
        dl, _ = ttr.decode_step(cfg, params, cache, torch.zeros((2, 4), dtype=torch.long), 0)
    assert tuple(dl.shape) == (2, 4, 50) and bool(torch.isfinite(dl).all())


def test_vlm_patch_concat_and_mrope():
    cfg = TConfig(name="v", family="vlm", num_layers=2, d_model=64, num_heads=4,
                  num_kv_heads=2, d_ff=128, vocab_size=100, mrope=True,
                  mrope_sections=(4, 2, 2), num_patches=8)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, 100, (2, 16)), "patch_embeds": torch.randn(2, 8, 64)}
    with torch.no_grad():
        logits, _, _ = ttr.forward(cfg, params, batch)
    assert tuple(logits.shape) == (2, 24, 100)  # patches + text
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-large"])
def test_serve_main_prints_the_reference_summary(arch, capsys):
    args = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "16", "--gen", "4"]
    assert tserve.main([*args, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jserve.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMES} == \
        {k: v for k, v in want.items() if k not in TIMES}


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-large"])
def test_run_fixed_prompts_tokens_and_positions(arch):
    args = tserve.parser().parse_args(["--arch", arch, "--smoke", "--batch", "2",
                                       "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    cfg = tserve.configs.get_smoke(arch)
    batch = tserve.prompt_batch(cfg, 0, 2, 8, "cpu")
    if cfg.family == "audio":
        assert tuple(batch["tokens"].shape) == (2, cfg.num_codebooks, 8)
        assert tserve.first_decode_pos(cfg, 8) == 8
    else:
        assert tuple(batch["patch_embeds"].shape) == (2, cfg.num_patches, cfg.d_model)
        assert tserve.first_decode_pos(cfg, 8) == 8 + cfg.num_patches
    again = tserve.prompt_batch(cfg, 0, 2, 8, "cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    run = tserve.run_fixed(cfg, tserve.init_params(cfg, 0, "cpu"), args, torch.device("cpu"))
    want = (2, cfg.num_codebooks, 3) if cfg.family == "audio" else (2, 3)
    assert tuple(run.tokens.shape) == want
    assert bool(((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all())
