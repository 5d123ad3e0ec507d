"""Global Momentum Fusion — the paper's core contribution (Eq. 2).

    Z = | (1 - tau) * N(V) + tau * N(M) |

with N the per-tensor L2 normalisation. ``tau = 0`` selects the same mask
as plain DGC; ``tau > 0`` pulls the clients' masks towards the shared
global momentum M, so the union of their uploads (the download) shrinks.

The port writes the client axis out: every tensor here is a ``[k, ...]``
stack and each client row is normalised on its own. The compression state
is flat (``utils/flat.py``): a ``[k, N]`` stack whose (client, leaf)
segments are normalised each on its own, as the JAX package normalises
each leaf.
"""

from __future__ import annotations

import torch
import torch.distributed

from repro_torch.utils.device import scalar


def rows(x, like: torch.Tensor) -> torch.Tensor:
    """A scalar or ``[k]`` tensor shaped to broadcast against the ``[k, ...]``
    stack ``like`` (one value per client row); a tensor of ``like``'s rank
    (one value per element) passes as it is."""
    x = scalar(x, like.device)
    if x.dim() in (0, like.dim()):
        return x
    return x.reshape((x.shape[0],) + (1,) * (like.dim() - 1))


def row_l2_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-client L2 norm of a ``[k, ...]`` stack, in float32 -> ``[k]``."""
    xf = x.float()
    return torch.sqrt(torch.sum(torch.square(xf), dim=tuple(range(1, xf.dim()))))


def l2_normalize(x: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
    """x / (||x||_2 + eps) per client row, in float32 (a division, as in
    the reference, not a multiplication by a reciprocal)."""
    xf = x.float()
    return xf / rows(row_l2_norm(xf) + eps, xf)


def gmf_score(v: torch.Tensor, m: torch.Tensor, tau, eps: float = 1e-16) -> torch.Tensor:
    """Fusion score Z (Eq. 2) of each client row: |(1−τ)·N(V) + τ·N(M)|;
    ``tau`` a scalar or ``[k]``."""
    t = rows(tau, v)
    return torch.abs((1.0 - t) * l2_normalize(v, eps) + t * l2_normalize(m, eps))


def segment_norms(x: torch.Tensor, layout) -> torch.Tensor:
    """Per-client L2 norm of every leaf segment of a flat ``[k, N]`` stack,
    in float32 -> ``[k, L]``. A segment cut over the layout's group
    (``FlatLayout.over``) sums its squares over the group first, a piece
    this rank does not own counting zero."""
    if not layout.cut:
        return torch.stack([row_l2_norm(seg) for seg in layout.segments(x.float())], dim=1)
    sq = torch.stack([torch.sum(torch.square(seg), dim=1)
                      for seg in layout.segments(x.float())], dim=1)
    idx = [i for i, cut in enumerate(layout.cut_flags) if cut]
    part = sq[:, idx].contiguous()
    if layout.shared:
        part = part * layout.owner_mask()
    torch.distributed.all_reduce(part, group=layout.group)
    sq[:, idx] = part
    return torch.sqrt(sq)


def segment_l2_normalize(x: torch.Tensor, layout, eps: float = 1e-16) -> torch.Tensor:
    """``l2_normalize`` of every (client, leaf) segment of a flat ``[k, N]``
    stack: each element divided by its segment's norm + eps."""
    xf = x.float()
    return xf / layout.expand(segment_norms(xf, layout) + eps)


def fednova_step_weight(local_steps, mean_steps, device=None) -> torch.Tensor:
    """FedNova-style weight n̄ / max(n_k, 1) on V in the fusion score."""
    ls, ms = scalar(local_steps, device), scalar(mean_steps, device)
    return ms / torch.clamp(ls, min=1.0)


def tau_schedule(round_idx, tau_max: float, warmup_rounds: int, device=None) -> torch.Tensor:
    """Paper §4.1 staircase: tau starts at 0 and steps up to ``tau_max`` in
    10 steps over ``warmup_rounds`` rounds. Float32 throughout, in the
    reference's order of operations."""
    t = scalar(round_idx, device)
    # divisors are tensors: CUDA divides by a Python scalar as a product
    # with its reciprocal, which can be one rounding off the division
    steps = scalar(10.0, device)
    step_len = torch.clamp(scalar(warmup_rounds / 10.0, device), min=1.0)
    frac = torch.minimum(torch.floor(t / step_len), steps) / steps
    return scalar(tau_max, device) * frac
