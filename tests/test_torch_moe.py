"""The port's MoE FFN (``repro_torch.models.moe``) and the moe family against
the JAX package's, on JAX-initialised params converted leaf for leaf and
numpy-seeded inputs.

Tolerances: per tensor, max |port − JAX| ≤ REL × max |JAX|, REL 1e-5 in
float32 and 3e-2 in bfloat16 (``tests/torch_parity.py``). The router is
float32 on both sides; ``torch.topk`` and ``jax.lax.top_k`` may order
exact ties otherwise, so expert ids are compared where the gap from the
last chosen probability to the next exceeds 1e-6. ``moe_dense``'s walk
over expert groups is held against the reference's all-at-once combine
at several group sizes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import torch_parity as tp_
from repro.configs import granite_moe_1b_a400m as jgranite
from repro.configs import kimi_k2_1t_a32b as jkimi
from repro.models import moe as jmoe
from repro_torch.configs import granite_moe_1b_a400m as tgranite
from repro_torch.configs import kimi_k2_1t_a32b as tkimi
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.utils.convert import from_jax_params

FAMILIES = {"granite": (jgranite, tgranite), "kimi": (jkimi, tkimi)}


def _moe(dtype, seed=3, **kw):
    jcfg, tcfg = tp_.configs(jgranite, tgranite, dtype, **kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), layout="transformer")
    return jcfg, tcfg, jp, tp


def _x(rng, shape, dtype):
    a = rng.normal(size=shape).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_topk_matches(dtype):
    jcfg, tcfg, jp, tp = _moe(dtype)
    jx, tx = _x(np.random.default_rng(0), (40, jcfg.d_model), dtype)
    jeids, jgates, jaux = jmoe.router_topk(jp, jcfg, jx)
    teids, tgates, taux = tmoe.router_topk(tp, tcfg, tx)
    assert tgates.dtype == tx.dtype and taux.dtype == torch.float32
    probs = np.asarray(jax.nn.softmax(jx.astype(jnp.float32) @ jp["router"], axis=-1))
    srt = -np.sort(-probs, axis=-1)
    k = jcfg.experts_per_token
    clear = srt[:, k - 1] - srt[:, k] > 1e-6  # no tie at the cut
    assert clear.any()
    assert np.array_equal(np.sort(teids.numpy()[clear], -1), np.sort(np.asarray(jeids)[clear], -1))
    assert tp_.rel_err(tgates[clear], np.asarray(jgates)[clear]) <= tp_.REL[dtype]
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group_elements", [None, 1, 2 * 24 * 256])
def test_moe_dense_matches_at_every_group_size(dtype, group_elements, monkeypatch):
    """The grouped walk (one expert at a time, two at a time, all at once)
    computes the reference's all-experts combine."""
    jcfg, tcfg, jp, tp = _moe(dtype)
    if group_elements is not None:
        monkeypatch.setattr(tmoe, "GROUP_ELEMENTS", group_elements)
    jx, tx = _x(np.random.default_rng(1), (2, 24, jcfg.d_model), dtype)
    want, jaux = jmoe.moe_dense(jp, jcfg, jx)
    got, aux = tmoe.moe_dense(tp, tcfg, tx)
    assert got.dtype == tx.dtype
    assert tp_.rel_err(got, want) <= tp_.REL[dtype]
    assert abs(float(aux) - float(jaux)) <= tp_.REL[dtype] * abs(float(jaux))


def test_group_size_bounds_the_intermediate():
    cfg = tkimi.CONFIG
    assert tmoe.group_size(cfg, 256) == tmoe.GROUP_ELEMENTS // (256 * 7168)
    assert tmoe.group_size(cfg, 4) == cfg.num_experts
    assert tmoe.group_size(tgranite.CONFIG, 8192) == 32
    assert tmoe.group_size(cfg, 1 << 30) == 1


@pytest.mark.parametrize("tokens", [1, 7, 100, 4096])
def test_capacity_per_expert_matches(tokens):
    for jm, tm in FAMILIES.values():
        assert tmoe.capacity_per_expert(tokens, tm.CONFIG) == \
            jmoe.capacity_per_expert(tokens, jm.CONFIG)


def test_init_moe_layout_matches_reference():
    jcfg, tcfg, jp, _ = _moe("bfloat16")
    own = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg)
    assert set(own) == set(jp)
    for name, leaf in own.items():
        assert tuple(leaf.shape) == jp[name].shape
        assert str(leaf.dtype).split(".")[-1] == str(jp[name].dtype)
    assert own["router"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_moe_family_forward_prefill_decode_match(family, dtype):
    jm, tm = FAMILIES[family]
    jcfg, tcfg = tp_.configs(jm, tm, dtype)
    jp, tp = tp_.params(jcfg)
    jb, tb = tp_.prompts(jcfg, 2, 20)
    tp_.check_forward(jcfg, tcfg, jp, tp, jb, tb, dtype)
    tp_.check_prefill_decode(jcfg, tcfg, jp, tp, jb, tb, dtype, prompt_len=20, gen=6,
                             cache_len=26)


def test_moe_prefill_then_decode_equals_forward():
    _, tcfg = tp_.configs(jgranite, tgranite, "float32")
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(1))
    _, tb = tp_.prompts(tcfg, 2, 24, seed=2)
    tp_.check_prefill_then_decode_equals_forward(tcfg, params, tb, 20, 4)


def test_expert_parallel_over_a_mesh_is_not_ported():
    """``moe_impl="ep"`` without a mesh takes the dense path, as the
    reference does; inside the forward over a mesh whose model axis is over
    1 the FFN takes ``moe_ep`` with the forward's model group, the tokens
    replicated over it (ROADMAP item 11 part C2a; the name is older than
    the port and kept). ``moe_ep`` under that group is held against JAX's
    gradients in ``tests/test_torch_moe_ep.py``, and inside the four-rank
    train steps in ``tests/test_torch_dist_step.py``."""
    from repro_torch.launch.mesh import AbstractMesh

    cfg = dataclasses.replace(tgranite.smoke(), moe_impl="ep")
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    with torch.no_grad():
        logits, aux, _ = ttr.forward(cfg, params, batch)
        assert bool(torch.isfinite(logits).all()) and float(aux) > 0
    mesh, group = AbstractMesh((1, 2), ("data", "model")), object()
    calls = []
    real = ttr.moe.moe_ep
    ttr.moe.moe_ep = lambda p, c, x, **kw: calls.append((x.shape, kw)) or (x, aux)
    try:
        layer = {"moe": {k: v[0] for k, v in params["layers"][0]["moe"].items()}}
        ttr._ffn(layer, cfg, torch.zeros(1, 4, cfg.d_model),
                 {"mesh": mesh, "tp": group, "data_axes": ("data",), "model_axis": "model"})
    finally:
        ttr.moe.moe_ep = real
    (shape, kw), = calls
    assert shape == (1, 4, cfg.d_model) and kw["tp"] is group and kw["mesh"] is mesh
