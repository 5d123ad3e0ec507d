"""Shared parity routine of the family tests (``test_torch_moe.py``,
``test_torch_ssm.py``, ``test_torch_rglru.py``, ``test_torch_vlm_audio.py``):
one family's ``smoke()`` config through the JAX package and the port, on
JAX-initialised params converted leaf for leaf and numpy-seeded prompts.

Tolerances (``REL``): per tensor, max |port − JAX| ≤ REL × max |JAX|,
1e-5 in float32 (the frameworks sum matrix products in other orders) and
3e-2 in bfloat16 (each rounds its bf16 products and elementwise ops
itself). Greedy tokens must be equal in float32; in bfloat16 both sides
are fed JAX's tokens, so that a near-tie argmax cannot fork the runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.dist import step as jstep
from repro.models import transformer as jtr
from repro_torch.dist import step as tstep
from repro_torch.models import transformer as ttr
from repro_torch.utils import tree_leaves
from repro_torch.utils.convert import from_jax_params

REL = {"float32": 1e-5, "bfloat16": 3e-2}


def rel_err(got, want):
    """max |got − want| / max |want|, got a torch tensor, want array-like."""
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def configs(jmod, tmod, dtype, **overrides):
    """The JAX and port ``smoke()`` configs at ``dtype``, equal field for field."""
    jcfg, tcfg = jmod.smoke(), tmod.smoke()
    if dtype != "float32":
        overrides = dict(overrides, dtype=dtype, param_dtype=dtype)
    jcfg = dataclasses.replace(jcfg, **overrides)
    tcfg = dataclasses.replace(tcfg, **overrides)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def params(jcfg, seed=7):
    """(JAX params, the port's copy of them)."""
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp), layout="transformer")


def prompts(cfg, b, t, seed=0):
    """The same prompt batch as (JAX dict, port dict): tokens (B, T), audio
    (B, K, T); vlm adds patch embeddings (B, P, d)."""
    rng = np.random.default_rng(seed)
    shape = (b, cfg.num_codebooks, t) if cfg.family == "audio" else (b, t)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens).long()}
    if cfg.family == "vlm":
        patches = rng.normal(size=(b, cfg.num_patches, cfg.d_model)).astype(np.float32)
        jb["patch_embeds"], tb["patch_embeds"] = jnp.asarray(patches), torch.from_numpy(patches)
    return jb, tb


def check_forward(jcfg, tcfg, jp, tp, jb, tb, dtype):
    """Full-sequence logits and aux loss; returns the port's logits."""
    want, jaux, _ = jtr.forward(jcfg, jp, jb)
    with torch.no_grad():
        got, aux, cache = ttr.forward(tcfg, tp, tb)
    assert cache is None and aux.dtype == torch.float32
    assert rel_err(got, want) <= REL[dtype]
    assert abs(float(aux) - float(jaux)) <= REL[dtype] * max(abs(float(jaux)), 1e-30)
    return got


def check_prefill_decode(jcfg, tcfg, jp, tp, jb, tb, dtype, *, prompt_len, gen, cache_len,
                         meshes=(None, None)):
    """The serving steps: prefill logits and cache, then ``gen`` greedy
    decode steps (logits, tokens, the final cache). ``meshes`` (JAX mesh,
    port mesh) builds both packages' steps over a mesh."""
    jmesh, tmesh = meshes
    jprefill = jax.jit(jstep.make_prefill_step(jcfg, jmesh, cache_len=cache_len))
    jserve = jax.jit(jstep.make_serve_step(jcfg, jmesh))
    tprefill = tstep.make_prefill_step(tcfg, tmesh, cache_len=cache_len)
    tserve = tstep.make_serve_step(tcfg, tmesh)

    jlast, jcache = jprefill(jp, jb)
    tlast, tcache = tprefill(tp, tb)
    assert tlast.dtype == torch.float32
    assert rel_err(tlast, jlast) <= REL[dtype]
    shapes = [tuple(x.shape) for x in tree_leaves(tcache)]
    assert shapes == [x.shape for x in jax.tree_util.tree_leaves(jcache)]
    for got, want in zip(tree_leaves(tcache), jax.tree_util.tree_leaves(jcache), strict=True):
        assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            str(want.dtype)]
        assert rel_err(got, want) <= REL[dtype]

    pos0 = prompt_len + (jcfg.num_patches if jcfg.family == "vlm" else 0)
    jtok = jnp.argmax(jlast, axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tlast, dim=-1)
    for i in range(gen):
        pos = pos0 + i
        if dtype == "float32":
            assert ttok.tolist() == np.asarray(jtok).tolist(), f"step {i}"
        else:
            ttok = torch.from_numpy(np.array(jtok)).long()
        jtok, jlogits, jcache = jserve(jp, jcache, jtok, jnp.asarray(pos, jnp.int32))
        ttok, tlogits, tcache = tserve(tp, tcache, ttok, torch.tensor(pos))
        assert rel_err(tlogits, jlogits) <= REL[dtype], f"step {i}"
    assert [tuple(x.shape) for x in tree_leaves(tcache)] == shapes  # caches keep their shapes
    for got, want in zip(tree_leaves(tcache), jax.tree_util.tree_leaves(jcache), strict=True):
        assert rel_err(got, want) <= REL[dtype]


def check_prefill_then_decode_equals_forward(tcfg, tp, tb, prompt_len, extra):
    """The port's own invariant (the reference's ``tests/test_models.py``):
    prefilling ``prompt_len`` tokens, then decoding ``extra`` more one at a
    time, gives the full forward's logits at those positions (float32)."""
    off = tcfg.num_patches if tcfg.family == "vlm" else 0  # vlm: patches come first
    full_t = off + prompt_len + extra
    with torch.no_grad():
        full, _, _ = ttr.forward(tcfg, tp, tb)
        head = {k: (v[..., :prompt_len] if k == "tokens" else v) for k, v in tb.items()}
        _, _, cache = ttr.forward(tcfg, tp, head, ctx={"want_cache": True, "cache_len": full_t})
        for i in range(extra):
            tok = tb["tokens"][..., prompt_len + i]
            logits, cache = ttr.decode_step(tcfg, tp, cache, tok, off + prompt_len + i)
            want = full[..., off + prompt_len + i, :]
            err = (logits - want).abs().max() / want.abs().max()
            assert float(err) <= 1e-4, f"step {i}: {float(err):.3e}"
