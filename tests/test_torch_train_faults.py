"""Training through the families that could not be differentiated
before: the hybrid's RG-LRU scan (recurrentgemma-9b) and the MoE FFN
(granite-moe, kimi-k2) under autograd and under
``torch.func.vmap(torch.func.grad)``, the way every engine takes client
gradients, against ``jax.grad`` of the same loss on the JAX package.

Tolerance: per leaf, max |port − JAX| ≤ 1e-5 × max |JAX| (float32; the
frameworks sum matrix products in other orders). ``vmap(grad)`` is held
against a loop of ``grad`` over the clients within 1e-6 of each leaf's
largest magnitude, and the scan's no-grad (in place) and grad (out of
place) paths give the same bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import torch_parity as tp_
from repro.configs import granite_moe_1b_a400m as jgranite
from repro.configs import kimi_k2_1t_a32b as jkimi
from repro.configs import recurrentgemma_9b as jrg
from repro.models import rglru as jrglru
from repro.models import transformer as jtr
from repro_torch.configs import granite_moe_1b_a400m as tgranite
from repro_torch.configs import kimi_k2_1t_a32b as tkimi
from repro_torch.configs import recurrentgemma_9b as trg
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttr
from repro_torch.utils import tree_leaves, tree_unflatten

REL = 1e-5
FAMILIES = {"recurrentgemma": (jrg, trg), "granite": (jgranite, tgranite),
            "kimi": (jkimi, tkimi)}


def _jloss(cfg):
    def loss(p, batch):
        logits, aux, _ = jtr.forward(cfg, p, batch)
        return jnp.mean(jax.nn.logsumexp(logits.astype(jnp.float32), axis=-1)) + aux
    return loss


def _tloss(cfg):
    def loss(p, batch):
        logits, aux, _ = ttr.forward(cfg, p, batch)
        return torch.mean(torch.logsumexp(logits.float(), dim=-1)) + aux
    return loss


def _leaf_errs(got_tree, want_tree):
    return [tp_.rel_err(g, w) for g, w in
            zip(tree_leaves(got_tree), jax.tree_util.tree_leaves(want_tree), strict=True)]


def _old_inplace_scan(a, b):
    """The scan as it stood before the gradient path split off."""
    a, b = a.clone(), b.clone()
    t, s = a.shape[1], 1
    while s < t:
        b[:, s:] += a[:, s:] * b[:, :-s]
        if 2 * s < t:
            a[:, s:] = a[:, s:] * a[:, :-s]
        s *= 2
    return b


def test_f4_scan_paths_bitwise_and_gradient_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 0.999, size=(2, 37, 8)).astype(np.float32)
    b = rng.normal(size=(2, 37, 8)).astype(np.float32)
    h0 = rng.normal(size=(2, 8)).astype(np.float32)
    ta, tb, th = (torch.from_numpy(x) for x in (a, b, h0))
    with torch.no_grad():
        plain = trglru.rglru_scan(ta, tb)
        plain_h0 = trglru.rglru_scan(ta, tb, th)
    assert torch.equal(plain, _old_inplace_scan(ta, tb))
    ga, gb, gh = (x.clone().requires_grad_(True) for x in (ta, tb, th))
    out = trglru.rglru_scan(ga, gb, gh)
    assert torch.equal(out.detach(), plain_h0)  # same bits with a gradient
    w = rng.normal(size=out.shape).astype(np.float32)
    (out * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda a_, b_, h_: jnp.sum(jrglru.rglru_scan(a_, b_, h_) * w),
                  argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    for got, want in zip((ga.grad, gb.grad, gh.grad), jg, strict=True):
        assert tp_.rel_err(got, want) <= REL


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gradients_match_jax_plain_and_under_vmap(family):
    jmod, tmod = FAMILIES[family]
    jcfg, tcfg = tp_.configs(jmod, tmod, "float32")
    jp, tp = tp_.params(jcfg, seed=3)
    k, b, t = 2, 2, 12
    batches = [tp_.prompts(jcfg, b, t, seed=10 + i) for i in range(k)]
    jgrad = jax.jit(jax.grad(_jloss(jcfg)))
    want = [jgrad(jp, jb) for jb, _ in batches]

    tloss = _tloss(tcfg)
    loop = []
    for i, (_, tb) in enumerate(batches):
        live = [x.clone().requires_grad_(True) for x in tree_leaves(tp)]
        grads = torch.autograd.grad(tloss(tree_unflatten(tp, live), tb), live)
        assert max(_leaf_errs(grads, want[i])) <= REL, family
        loop.append(torch.func.grad(tloss)(tp, tb))
    stacked = {key: torch.stack([tb[key] for _, tb in batches]) for key in batches[0][1]}
    vgrads = torch.func.vmap(torch.func.grad(tloss), in_dims=(None, 0))(tp, stacked)
    for i in range(k):
        per = [x[i] for x in tree_leaves(vgrads)]
        assert max(_leaf_errs(per, want[i])) <= REL, family
        for got, ref in zip(per, tree_leaves(loop[i]), strict=True):
            scale = max(float(ref.abs().max()), 1e-30)
            assert float((got - ref).abs().max()) <= 1e-6 * scale


def test_f5_moe_one_hot_and_combine_under_vmap(monkeypatch):
    jcfg, tcfg = tp_.configs(jgranite, tgranite, "float32")
    _, tp = tp_.params(jcfg, seed=5)
    moe_p = {k: v[0] for k, v in tp["layers"][0]["moe"].items()}  # layer 0's experts
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 2, 5, tcfg.d_model)).astype(np.float32))
    loop = torch.stack([tmoe.moe_dense(moe_p, tcfg, xi)[0] for xi in x])
    batched = torch.func.vmap(lambda xi: tmoe.moe_dense(moe_p, tcfg, xi)[0])(x)
    assert float((batched - loop).abs().max()) <= 1e-6 * float(loop.abs().max())
    # the group walk keeps its bound: at a bound of one expert's
    # intermediate it walks one expert at a time, under vmap too
    tokens, width = 2 * 5, max(tcfg.d_model, tcfg.d_ff)
    monkeypatch.setattr(tmoe, "GROUP_ELEMENTS", tokens * width)
    assert tmoe.group_size(tcfg, tokens) == 1
    walked = torch.func.vmap(lambda xi: tmoe.moe_dense(moe_p, tcfg, xi)[0])(x)
    assert float((walked - loop).abs().max()) <= 1e-6 * float(loop.abs().max())
