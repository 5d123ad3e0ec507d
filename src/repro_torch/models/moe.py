"""Mixture-of-Experts FFN (Kimi-K2 / Granite-MoE style: softmax top-k
router): the port of the reference's ``models/moe.py``, dense dispatch.

``moe_dense`` computes the reference's function: every expert on every
token, combined with the router's gates (exact, no token dropping). The
reference builds the whole ``(E, BT, d)`` expert output before it
combines; at kimi-k2's width that is 384 × BT × 7168. The port walks the
experts in groups whose ``(group, BT, max(d, f))`` intermediates stay under
``GROUP_ELEMENTS`` and adds each group's gated output into a float32
``(BT, d)`` accumulator, so nothing of size E × BT × d is ever held. The
walk has no host sync: which experts a token chose changes the gates, not
the work. The one-hot is a comparison with ``arange(E)`` and the combine
table and the group sum are built out of place, so the function runs
under ``torch.func.vmap`` (the engines take client gradients that way).

The router stays float32; the gates are cast to x's dtype, as in the
reference.

Not ported yet: the expert-parallel path (``moe_ep``, ``dispatch_local``,
``combine_local`` and the all-to-all bodies), which needs the dist
runtime's sharded half (ROADMAP Queue 1 item 11 part B).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

# Bound on the elements of one expert group's intermediate (group × BT ×
# max(d, f)): 2^28 is 512 MiB in bfloat16.
GROUP_ELEMENTS = 1 << 28


def _expert_weights(gen, e, d_in, d_out, dtype):
    """(e, d_in, d_out) expert kernels drawn one expert at a time, so the
    float32 draw is one expert's, never the whole stack's."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
    for i in range(e):
        out[i] = layers.truncated_normal_init(gen, (d_in, d_out), d_in**-0.5, dtype)
    return out


def init_moe(gen, cfg, dtype=None):
    dtype = dtype or layers.dtype_of(cfg.param_dtype)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": layers.dense_init(gen, d, e, torch.float32),  # router kept fp32
        "w_gate": _expert_weights(gen, e, d, f, dtype),
        "w_up": _expert_weights(gen, e, d, f, dtype),
        "w_down": _expert_weights(gen, e, f, d, dtype),
    }


def router_topk(params, cfg, x):
    """Route: returns (eids (..., k) int64, gates (..., k) in x's dtype,
    aux_loss float32 scalar)."""
    logits = x.float() @ params["router"]  # (..., E)
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # Switch-style load-balance aux loss: E * sum_e f_e * p_e
    e = cfg.num_experts
    lead = tuple(range(eids.dim() - 1))
    density = _one_hot(eids, e).float().sum(dim=-2).mean(dim=lead)  # tokens per expert (×k)
    mean_prob = probs.mean(dim=lead)
    aux = e * torch.sum(density / cfg.experts_per_token * mean_prob)
    return eids, gates.to(x.dtype), aux


def _one_hot(ids, n):
    """``F.one_hot`` as a comparison with ``arange(n)``: int64, with no read
    of the ids' values on the host, so it runs under ``torch.func.vmap``."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def group_size(cfg, tokens: int) -> int:
    """Experts per group of ``moe_dense``'s walk for ``tokens`` tokens."""
    per_expert = tokens * max(cfg.d_model, cfg.d_ff)
    return max(1, min(cfg.num_experts, GROUP_ELEMENTS // max(per_expert, 1)))


def moe_dense(params, cfg, x):
    """All experts on all tokens, combined by the gates. x: (B, T, d).
    Returns (y (B, T, d), aux)."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    eids, gates, aux = router_topk(params, cfg, xf)
    e = cfg.num_experts
    # (BT, E): each token's gate on the experts it chose, 0 elsewhere. The
    # chosen experts are distinct, so each entry sums one gate and zeros.
    combine = (_one_hot(eids, e).to(gates.dtype) * gates[..., None]).sum(dim=-2)
    y = None
    step = group_size(cfg, b * t)
    for e0 in range(0, e, step):
        sl = slice(e0, min(e0 + step, e))
        h = F.silu(xf @ params["w_gate"][sl]) * (xf @ params["w_up"][sl])  # (g, BT, f)
        out = h @ params["w_down"][sl]  # (g, BT, d)
        part = torch.einsum("gbd,bg->bd", out, combine[:, sl]).float()
        y = part if y is None else y + part
    return y.to(x.dtype).reshape(b, t, d), aux


def capacity_per_expert(tokens: int, cfg) -> int:
    """Fixed per-expert buffer length (local to one model rank's dispatch)."""
    mean = tokens * cfg.experts_per_token / cfg.num_experts
    return max(1, int(mean * cfg.capacity_factor + 0.999))
