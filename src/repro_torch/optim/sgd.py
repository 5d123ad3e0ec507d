"""SGD optimiser + LR schedules: the port of the reference's
``optim/sgd.py`` (paper setting: plain SGD at the client, momentum lives
in the compression scheme's correction term).

Optimiser-level momentum/weight-decay/grad-clip are provided for the
beyond-paper production configs (they compose with any compression scheme:
the optimiser consumes the *broadcast aggregated* gradient Ĝ).

Dtypes are the reference's: the learning rate is a float32 value (``lr_at``
computes it in float32, op for op), the step is taken in float32 and cast
back to each param's dtype, and the Python coefficients round to the dtype
of the array they scale, as JAX's weakly typed scalars do.

Under tensor parallelism or FSDP (``group``, the ranks the leaves are cut
over, ``cut``, which leaves are the rank's pieces, and ``owner``, whether
this rank's piece of a cut leaf counts: False where another rank of the
group holds the same piece) the clip's global norm sums the cut leaves'
squares over the group and counts the whole ones once.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils import tree_l2_norm, tree_leaves, tree_map, tree_zeros_like, weak


class SGDState(NamedTuple):
    momentum: Any  # {} when momentum == 0


def init(params, *, momentum: float = 0.0) -> SGDState:
    return SGDState(momentum=tree_zeros_like(params) if momentum > 0 else {})


def apply_updates(
    params,
    grads,
    state: SGDState,
    *,
    lr,
    momentum: float = 0.0,
    weight_decay: float = 0.0,
    grad_clip: float = 0.0,
    nesterov: bool = False,
    group=None,
    cut=None,
    owner=None,
):
    if grad_clip > 0.0:
        norm = global_norm(grads, group, cut, owner)
        scale = torch.clamp(grad_clip / (norm + 1e-12), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
    if weight_decay > 0.0:
        grads = tree_map(lambda g, w: g + weak(weight_decay, g.dtype) * w.to(g.dtype),
                         grads, params)
    if momentum > 0.0:
        mom = tree_map(lambda m, g: weak(momentum, m.dtype) * m + g.to(m.dtype),
                       state.momentum, grads)
        if nesterov:
            update = tree_map(lambda g, m: g.to(m.dtype) + weak(momentum, m.dtype) * m,
                              grads, mom)
        else:
            update = mom
        state = SGDState(momentum=mom)
    else:
        update = grads
    lr = float(lr)
    params = tree_map(lambda w, u: (w.float() - lr * u.float()).to(w.dtype), params, update)
    return params, state


def global_norm(grads, group=None, cut=None, owner=None) -> torch.Tensor:
    """The L2 norm of the whole gradient (float32 device scalar): the
    leaves' own, or with ``group`` the cut leaves' squares (``cut`` a bool
    a leaf) summed over the group beside the whole ones'; a cut leaf whose
    ``owner`` flag is False (another rank's piece to count) adds zero."""
    if group is None or not any(cut):
        return tree_l2_norm(grads)
    leaves = tree_leaves(grads)
    owner = (True,) * len(leaves) if owner is None else owner
    squares = [torch.sum(torch.square(x.float())) for x in leaves]
    part = sum(q if o else torch.zeros_like(q)
               for q, c, o in zip(squares, cut, owner, strict=True) if c).reshape(1)
    dist.all_reduce(part, group=group)
    rest = [q for q, c in zip(squares, cut, strict=True) if not c]
    return torch.sqrt(part[0] + sum(rest)) if rest else torch.sqrt(part[0])


def lr_at(step, cfg) -> float:
    """Schedule from TrainConfig: constant | cosine | step (+ linear
    warmup), in float32 as the reference computes it; returns the float32
    value as a Python float."""
    f32 = np.float32
    base = f32(cfg.learning_rate)
    t = f32(step)
    if cfg.warmup_steps > 0:
        warm = np.minimum(f32(1.0), (t + f32(1.0)) / f32(cfg.warmup_steps))
    else:
        warm = f32(1.0)
    if cfg.lr_schedule == "constant":
        return float(base * warm)
    if cfg.lr_schedule == "cosine":
        span = f32(max(cfg.total_steps - cfg.warmup_steps, 1))
        frac = np.clip((t - f32(cfg.warmup_steps)) / span, f32(0.0), f32(1.0))
        return float(base * warm * f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * frac)))
    if cfg.lr_schedule == "step":
        period = f32(max(cfg.total_steps // 3, 1))
        return float(base * warm * (f32(0.5) ** np.floor_divide(t, period)))
    raise ValueError(cfg.lr_schedule)
