"""The port's Mamba-2 SSD mixer (``repro_torch.models.ssm``), the causal
conv it shares with the RG-LRU block, and the ssm family (mamba2-780m's
``smoke()``) against the JAX package's, on JAX-initialised params converted
leaf for leaf and numpy-seeded inputs.

Tolerances: per tensor, max |port − JAX| ≤ REL × max |JAX|, REL 1e-5 in
float32 and 3e-2 in bfloat16 (``tests/torch_parity.py``); the reference's
own invariants (the chunked scan equals its stepwise recurrence, prefill →
decode equals the full forward) within its 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import torch_parity as tp_
from repro.configs import mamba2_780m as jmamba
from repro.configs.base import ModelConfig as JConfig
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.configs import mamba2_780m as tmamba
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.utils import tree_leaves
from repro_torch.utils.convert import from_jax_params

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(name="s", family="ssm", num_layers=1, d_model=32, vocab_size=10, ssm_state=8,
             ssm_headdim=16, ssd_chunk=8)


def _pair(a, dtype):
    jd, td = DT[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _ssm(dtype, seed=3, **kw):
    cfg = dict(SMALL, **kw)
    if dtype != "float32":
        cfg.update(dtype=dtype, param_dtype=dtype)
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                                           layout="transformer")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_and_step_match(dtype):
    rng = np.random.default_rng(0)
    jp = jlayers.init_conv1d(jax.random.PRNGKey(1), 12, 4, DT[dtype][0])
    jp["bias"] = jnp.asarray(_normal(rng, (12,)), DT[dtype][0])
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), layout="transformer")
    assert tuple(tp["kernel"].shape) == (4, 12)  # the reference's (W, C) layout
    jx, tx = _pair(_normal(rng, (2, 9, 12)), dtype)
    assert tp_.rel_err(tlayers.causal_conv1d(tp, tx), jlayers.causal_conv1d(jp, jx)) \
        <= tp_.REL[dtype]
    js, ts = _pair(_normal(rng, (2, 3, 12)), dtype)
    jxt, txt = _pair(_normal(rng, (2, 12)), dtype)
    jstate, jout = jlayers.causal_conv1d_step(jp, js, jxt)
    tstate, tout = tlayers.causal_conv1d_step(tp, ts, txt)
    assert tp_.rel_err(tout, jout) <= tp_.REL[dtype]
    assert torch.equal(tstate, torch.cat([ts[:, 1:], txt[:, None]], dim=1))
    assert tp_.rel_err(tstate, jstate) == 0


def test_segsum_matches():
    a = _normal(np.random.default_rng(1), (2, 3, 8))
    got = tssm._segsum(torch.from_numpy(a))
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    finite = np.isfinite(want)
    assert np.array_equal(finite, torch.isfinite(got).numpy())
    np.testing.assert_allclose(got.numpy()[finite], want[finite], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches(dtype, with_state):
    rng = np.random.default_rng(2)
    b, t, h, p, g, n = 2, 24, 4, 8, 2, 6
    jx, tx = _pair(_normal(rng, (b, t, h, p)), dtype)
    a = -np.abs(_normal(rng, (b, t, h), 0.3))
    jb, tb = _pair(_normal(rng, (b, t, g, n)), dtype)
    jc, tc = _pair(_normal(rng, (b, t, g, n)), dtype)
    s0 = _normal(rng, (b, h, p, n)) if with_state else None
    want_y, want_s = jssm.ssd_chunked(jx, jnp.asarray(a), jb, jc, 8,
                                      None if s0 is None else jnp.asarray(s0))
    got_y, got_s = tssm.ssd_chunked(tx, torch.from_numpy(a), tb, tc, 8,
                                    None if s0 is None else torch.from_numpy(s0))
    assert got_y.dtype == tx.dtype and got_s.dtype == torch.float32
    assert tp_.rel_err(got_y, want_y) <= tp_.REL[dtype]
    assert tp_.rel_err(got_s, want_s) <= tp_.REL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [29, 3, 16])  # padded to the chunk, shorter than the conv, exact
def test_ssm_forward_and_decode_step_match(dtype, t):
    jcfg, tcfg, jp, tp = _ssm(dtype)
    rng = np.random.default_rng(t)
    jx, tx = _pair(_normal(rng, (2, t, 32), 0.5), dtype)
    want_y, (want_s, want_tail) = jssm.ssm_forward(jp, jcfg, jx)
    got_y, (got_s, got_tail) = tssm.ssm_forward(tp, tcfg, tx)
    assert tp_.rel_err(got_y, want_y) <= tp_.REL[dtype]
    assert tp_.rel_err(got_s, want_s) <= tp_.REL[dtype]
    assert tuple(got_tail.shape) == want_tail.shape
    assert tp_.rel_err(got_tail, want_tail) <= tp_.REL[dtype]
    # one decode step from the prefill's state and conv tail
    jxt, txt = _pair(_normal(rng, (2, 32), 0.5), dtype)
    jy, jc = jssm.ssm_decode_step(jp, jcfg, {"state": want_s, "conv": want_tail}, jxt)
    ty, tc = tssm.ssm_decode_step(tp, tcfg, {"state": got_s, "conv": got_tail}, txt)
    assert tp_.rel_err(ty, jy) <= tp_.REL[dtype]
    assert tp_.rel_err(tc["state"], jc["state"]) <= tp_.REL[dtype]
    assert tp_.rel_err(tc["conv"], jc["conv"]) <= tp_.REL[dtype]


def test_ssd_matches_stepwise():
    """The chunked scan equals the exact recurrence, step by step (the
    reference's invariant, on the port alone)."""
    _, cfg, _, p = _ssm("float32")
    x = torch.from_numpy(_normal(np.random.default_rng(4), (2, 29, 32), 0.5))
    y_full, (final, _) = tssm.ssm_forward(p, cfg, x)
    cache = tssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    ys = []
    for t in range(29):
        y_t, cache = tssm.ssm_decode_step(p, cfg, cache, x[:, t])
        ys.append(y_t)
    np.testing.assert_allclose(y_full.numpy(), torch.stack(ys, 1).numpy(), atol=1e-4)
    np.testing.assert_allclose(final.numpy(), cache["state"].numpy(), atol=1e-4)


def test_init_ssm_and_cache_match_reference_layout():
    jcfg, tcfg, jp, _ = _ssm("bfloat16")
    own = tssm.init_ssm(torch.Generator().manual_seed(0), tcfg)
    for got, want in zip(tree_leaves(own), jax.tree_util.tree_leaves(jp), strict=True):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    for name in ("A_log", "D", "dt_bias"):  # deterministic leaves, equal
        np.testing.assert_allclose(own[name].numpy(), np.asarray(jp[name]), rtol=1e-6)
    jc = jssm.init_ssm_cache(jcfg, 3, jnp.bfloat16)
    tc = tssm.init_ssm_cache(tcfg, 3, torch.bfloat16, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    assert tc["state"].dtype == torch.float32 and tc["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_family_forward_prefill_decode_match(dtype):
    jcfg, tcfg = tp_.configs(jmamba, tmamba, dtype)
    jp, tp = tp_.params(jcfg)
    jb, tb = tp_.prompts(jcfg, 2, 21)  # not a multiple of ssd_chunk 16
    tp_.check_forward(jcfg, tcfg, jp, tp, jb, tb, dtype)
    tp_.check_prefill_decode(jcfg, tcfg, jp, tp, jb, tb, dtype, prompt_len=21, gen=6,
                             cache_len=27)


def test_ssm_prefill_then_decode_equals_forward():
    _, tcfg = tp_.configs(jmamba, tmamba, "float32")
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(1))
    _, tb = tp_.prompts(tcfg, 2, 24, seed=3)
    tp_.check_prefill_then_decode_equals_forward(tcfg, params, tb, 19, 5)


def test_ssm_decode_cache_is_written_in_place_and_keeps_its_shapes():
    cfg = tmamba.smoke()
    params = ttr.init_params(cfg, torch.Generator().manual_seed(2))
    cache = ttr.init_cache(cfg, 2, 8, device="cpu")
    before = [(x.data_ptr(), tuple(x.shape)) for x in tree_leaves(cache)]
    with torch.no_grad():
        for pos in range(3):
            _, out = ttr.decode_step(cfg, params, cache, torch.tensor([1, 2]), pos)
    assert out is cache
    assert [(x.data_ptr(), tuple(x.shape)) for x in tree_leaves(cache)] == before
    assert all(bool(x.any()) for x in tree_leaves(cache))
