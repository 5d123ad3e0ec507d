"""Top-k mask selection for gradient sparsification, per client row.

Every score tensor is a ``[k, ...]`` stack with the client axis first;
thresholds come back as ``[k]`` device tensors and masks keep the stack's
shape. Two threshold estimators, as in the JAX package:

* ``exact``   — the k-th largest value of each client's flattened scores
  (``torch.topk``). The k-th largest *value* of a multiset does not depend
  on the algorithm, so it is bitwise the reference's ``lax.top_k`` value.
* ``sampled`` — Deep Gradient Compression's estimator: the k-th largest of
  a strided sample of about 16k elements, taken without flattening.

The strided sample follows the tensor's shape; convolution kernels are
OIHW here and HWIO in the JAX package, so for those leaves the two
packages sample different (statistically equivalent) elements.

The compression state is flat (``utils/flat.py``): ``segment_thresholds``
and ``segment_topk_mask`` select per (client, leaf) segment of a
``[k, N]`` stack, as the JAX package selects per leaf; a global top-k is
``topk_mask`` over the whole rows. On the card the exact per-segment
selection is a kernel (``kernels/ops.py: topk_abs_select``); these are its
plain version and the sampled estimator's path.

Per-client rates (the adaptive rate controller, ``core/rate_control.py``)
take the reference's dynamic-k path: ``num_keep_dynamic`` computes each
client's keep count on the device in float32 (a ``[k, L]`` table over the
layout's leaves, ``keep_table``), and ``dynamic_threshold`` is the k-th
largest of each row by a descending sort, the plain version of the
kernel's per-row keep table. The k-th largest value of a multiset is
unique, so for equal k both are bitwise ``torch.topk``'s.
"""

from __future__ import annotations

import math
from typing import Literal

import torch
import torch.distributed

Selector = Literal["exact", "sampled"]  # the threshold estimators
_SAMPLE_TARGET = 16384


def num_keep(n: int, rate: float) -> int:
    """Number of kept elements for compression rate ``rate`` (Python
    float64 ``ceil``, as in the reference)."""
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"compression rate must be in (0, 1], got {rate}")
    return max(1, min(n, int(math.ceil(rate * n))))


def exact_threshold(z_rows: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest value of each row of ``z_rows`` (``[rows, n]``) -> ``[rows]``."""
    return torch.topk(z_rows, k, dim=1).values[:, -1]


def sampled_threshold(z_rows: torch.Tensor, rate: float) -> torch.Tensor:
    """DGC's sampled threshold of each row of ``z_rows`` (``[rows, n]``): the
    k-th largest of a strided sample of about 16k elements -> ``[rows]``."""
    n = z_rows.shape[1]
    sample = z_rows[:, ::max(1, n // _SAMPLE_TARGET)]
    return exact_threshold(sample, num_keep(sample.shape[1], rate))


def strided_sample_nd(z: torch.Tensor, target: int = _SAMPLE_TARGET) -> torch.Tensor:
    """About ``target`` elements per client row, strided over each
    per-client dimension in turn (the reference's ``strided_sample_nd``
    applied to every row) -> ``[k, s]``."""
    shape = z.shape[1:]
    total = math.prod(shape)
    stride_budget = max(1, total // target)
    strides = []
    for d in shape:
        s = min(d, stride_budget)
        strides.append(s)
        stride_budget = max(1, stride_budget // s)
    sample = z[(slice(None),) + tuple(slice(None, None, s) for s in strides)]
    return sample.reshape(z.shape[0], -1)


def _bcast(thr: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return thr.reshape((thr.shape[0],) + (1,) * (like.dim() - 1))


def topk_mask(z: torch.Tensor, rate: float, selector: str = "exact") -> torch.Tensor:
    """{0,1} float32 mask keeping ~``rate`` of each client's largest ``|z|``."""
    za = torch.abs(z).float()
    if selector == "exact":
        thr = exact_threshold(za.reshape(za.shape[0], -1), num_keep(za[0].numel(), rate))
    elif selector == "sampled":
        sample = strided_sample_nd(za)
        thr = exact_threshold(sample, num_keep(sample.shape[1], rate))
    else:
        raise ValueError(f"unknown selector {selector!r}")
    return (za >= _bcast(thr, za)).float()


def whole_segment(seg: torch.Tensor, layout, i: int) -> torch.Tensor:
    """Segment ``i`` of every row of a score stack as the whole leaf's
    scores: the ranks' pieces gathered over the layout's group where the
    segment is cut (in rank order; a threshold does not depend on the
    order), the pieces of the ranks that do not own theirs left out, else
    the segment itself."""
    if not layout.cut_flags[i]:
        return seg
    size = torch.distributed.get_world_size(layout.group)
    parts = [torch.empty_like(seg, memory_format=torch.contiguous_format) for _ in range(size)]
    torch.distributed.all_gather(parts, seg.contiguous(), group=layout.group)
    if layout.shared_flags[i]:
        own = torch.tensor([float(layout.owner_flags[i])], device=seg.device)
        owners = [torch.empty_like(own) for _ in range(size)]
        torch.distributed.all_gather(owners, own, group=layout.group)
        parts = [p for p, o in zip(parts, owners, strict=True) if o.item()]
    return torch.cat(parts, dim=1)


def segment_thresholds(za: torch.Tensor, layout, rate: float,
                       selector: str = "exact") -> torch.Tensor:
    """The threshold of every (client, leaf) segment of a flat ``[k, N]``
    score stack -> ``[k, L]``: the exact k_i-th largest of the segment (of
    the whole leaf where it is cut over the layout's model group, the plain
    version of ``gmf_select``'s group mode), or the sampled estimate from a
    strided sample of the leaf in its shape."""
    out = []
    keep, _ = layout.keep(rate)
    for i, (seg, shape, k_i) in enumerate(zip(layout.segments(za), layout.shapes, keep,
                                              strict=True)):
        if selector == "exact":
            out.append(exact_threshold(whole_segment(seg, layout, i), k_i))
        elif selector == "sampled":
            sample = strided_sample_nd(seg.reshape(seg.shape[0], *shape))
            out.append(exact_threshold(sample, num_keep(sample.shape[1], rate)))
        else:
            raise ValueError(f"unknown selector {selector!r}")
    return torch.stack(out, dim=1)


def segment_topk_mask(z: torch.Tensor, layout, rate: float, selector: str = "exact"):
    """Every (client, leaf) segment's threshold of ``|z|`` and the {0,1}
    float32 mask keeping ~``rate`` of its largest -> (thr ``[k, L]``, mask
    ``[k, N]``). With the exact selector this is the plain version of
    ``gmf_select``'s |z| mode."""
    za = torch.abs(z).float()
    thr = segment_thresholds(za, layout, rate, selector)
    return thr, (za >= layout.expand(thr)).float()


def num_keep_dynamic(n, rate) -> torch.Tensor:
    """The reference's traced-rate ``num_keep``: ``ceil(float32(rate) · n)``
    in float32, clipped to [1, n], as int64. ``rate`` and ``n`` are tensors
    (or numbers) that broadcast; no host sync."""
    rate = torch.as_tensor(rate, dtype=torch.float32)
    n = torch.as_tensor(n, device=rate.device)
    k = torch.ceil(rate * n.to(torch.float32)).to(torch.int64)
    return torch.minimum(torch.clamp(k, min=1), n.to(torch.int64))


def keep_table(layout, rates: torch.Tensor) -> torch.Tensor:
    """Every (client, leaf) segment's keep count at the clients' rates
    ``[k]`` -> int64 ``[k, L]`` on the rates' device."""
    return num_keep_dynamic(layout.sizes_dev.to(rates.device)[None, :], rates[:, None])


def dynamic_threshold(z_rows: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The ``k[r]``-th largest value of each row of ``z_rows`` (``[rows, n]``,
    ``k`` int64 ``[rows]``) -> ``[rows]``: one descending sort per row and a
    gather, as the reference's ``dynamic_threshold``."""
    ordered = torch.sort(z_rows, dim=1, descending=True).values
    return torch.gather(ordered, 1, (k - 1).reshape(-1, 1))[:, 0]


def segment_keep_thresholds(za: torch.Tensor, layout, keep: torch.Tensor) -> torch.Tensor:
    """The ``keep[r, i]``-th largest of every (client, leaf) segment of a
    flat ``[k, N]`` score stack -> ``[k, L]``: the plain version of the
    kernel's per-row keep table."""
    return torch.stack([dynamic_threshold(seg, keep[:, i])
                        for i, seg in enumerate(layout.segments(za))], dim=1)


def segment_topk_mask_keep(z: torch.Tensor, layout, keep: torch.Tensor):
    """``segment_topk_mask`` at a per-row keep table ``[k, L]`` -> (thr
    ``[k, L]``, mask ``[k, N]``)."""
    za = torch.abs(z).float()
    thr = segment_keep_thresholds(za, layout, keep)
    return thr, (za >= layout.expand(thr)).float()


def segment_topk_mask_dynamic(z: torch.Tensor, layout, rates: torch.Tensor,
                              selector: str = "exact") -> torch.Tensor:
    """Per (client, leaf) segment masks of ``|z|`` at per-client rates
    ``[k]`` (the reference's ``topk_mask_dynamic`` on every leaf): exact,
    or the sampled estimate at each client's rate over the leaf's strided
    sample. Returns the mask ``[k, N]``."""
    if selector == "exact":
        return segment_topk_mask_keep(z, layout, keep_table(layout, rates))[1]
    if selector != "sampled":
        raise ValueError(f"unknown selector {selector!r}")
    za = torch.abs(z).float()
    thr = []
    for seg, shape in zip(layout.segments(za), layout.shapes, strict=True):
        sample = strided_sample_nd(seg.reshape(seg.shape[0], *shape))
        thr.append(dynamic_threshold(sample, num_keep_dynamic(sample.shape[1], rates)))
    return (za >= layout.expand(torch.stack(thr, dim=1))).float()


def topk_mask_dynamic(z: torch.Tensor, rates: torch.Tensor) -> torch.Tensor:
    """One exact threshold per client over its whole row at its own rate
    (global top-k, ``per_tensor=False``) -> the {0,1} mask."""
    za = torch.abs(z).float().reshape(z.shape[0], -1)
    thr = dynamic_threshold(za, num_keep_dynamic(za.shape[1], rates))
    return (za >= thr[:, None]).float().reshape(z.shape)
