"""AdamW optimiser: the port of the reference's ``optim/adamw.py``
(production trainer option; it consumes the broadcast aggregated
gradient Ĝ exactly like SGD does, so DGC/GMF semantics are unchanged).

In the reference's dtypes: the moments keep the params' dtype, the bias
corrections are float32 values (so the step promotes to float32), and the
update is taken in float32 and cast back to each param's dtype.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.utils import tree_map, tree_zeros_like, weak


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: int


def init(params) -> AdamWState:
    return AdamWState(mu=tree_zeros_like(params), nu=tree_zeros_like(params), count=0)


def apply_updates(
    params,
    grads,
    state: AdamWState,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
):
    count = state.count + 1
    # a step counter, not a size: bias correction needs b**t only, far below
    # 2^24 steps
    cf = np.float32(count)  # repro-noqa: REP003 (a step counter, far below 2^24)
    mu = tree_map(lambda m, g: weak(b1, m.dtype) * m + weak(1 - b1, m.dtype) * g.to(m.dtype),
                  state.mu, grads)
    nu = tree_map(lambda v, g: weak(b2, v.dtype) * v
                  + weak(1 - b2, v.dtype) * torch.square(g.to(v.dtype)), state.nu, grads)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** cf)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** cf)
    lr = float(lr)

    def upd(w, m, v):
        step = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + eps)
        if weight_decay > 0.0:
            step = step + weight_decay * w.to(step.dtype)
        return (w.float() - lr * step).to(w.dtype)

    params = tree_map(upd, params, mu, nu)
    return params, AdamWState(mu=mu, nu=nu, count=count)
