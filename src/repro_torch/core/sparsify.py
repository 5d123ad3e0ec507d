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

Over a layout of pieces cut across a mesh axis (``FlatLayout.over`` with
boxes) every selection is the whole leaves' and gives the rank's piece of
the mesh-less mask: the sampled estimator takes the points of the whole
leaf's strided sample that lie in the rank's box (``segment_sample``) and
gathers them over the group (``whole_sample``); global top-k finds the
exact k-th largest of the whole row by a radix select over the float32
bit patterns (``group_kth_largest``: a few passes of bin counts of the
entries that count on this rank, all-reduced between passes), gathering
no row. A tree of mixed dtypes (``GroupedLayout``) selects over its dtype
groups' stacks at once (``grouped_topk_masks``): over their concatenation,
or by the same radix select where they are cut over a group of ranks.
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


def _sample_strides(shape, target: int = _SAMPLE_TARGET) -> list[int]:
    """The strided sample's stride on each dim of a leaf of ``shape``."""
    stride_budget = max(1, math.prod(shape) // target)
    strides = []
    for d in shape:
        s = min(d, stride_budget)
        strides.append(s)
        stride_budget = max(1, stride_budget // s)
    return strides


def strided_sample_nd(z: torch.Tensor, target: int = _SAMPLE_TARGET) -> torch.Tensor:
    """About ``target`` elements per client row, strided over each
    per-client dimension in turn (the reference's ``strided_sample_nd``
    applied to every row) -> ``[k, s]``."""
    strides = _sample_strides(z.shape[1:], target)
    sample = z[(slice(None),) + tuple(slice(None, None, s) for s in strides)]
    return sample.reshape(z.shape[0], -1)


def segment_sample(seg: torch.Tensor, layout, i: int) -> torch.Tensor:
    """The points of leaf ``i``'s strided sample (of the whole leaf, in its
    shape) that segment ``i`` of a ``[k, N]`` stack holds -> ``[k, c]``: the
    whole sample where the segment is not cut, else the points inside the
    rank's box (whole coordinates that are multiples of the strides)."""
    x = seg.reshape(seg.shape[0], *layout.shapes[i])
    if not layout.cut_flags[i]:
        return strided_sample_nd(x)
    box = None if layout.boxes is None else layout.boxes[i]
    if box is None:
        raise ValueError("a cut leaf's sample needs the pieces' boxes: FlatLayout.over(..., "
                         "places=...)")
    at = tuple(slice((-a) % s, None, s) for a, s in zip(box.start, _sample_strides(box.shape)))
    return x[(slice(None),) + at].reshape(seg.shape[0], -1)


def whole_sample(sample: torch.Tensor, layout, i: int) -> tuple[torch.Tensor, int]:
    """Leaf ``i``'s whole strided sample of float32 scores from each rank's
    ``segment_sample`` of it -> (``[k, s]``, the sample's size c): where the
    leaf is cut, every rank's points gathered over the group (a collective)
    and padded to the same width with -inf (s ≥ c; a rank that does not own
    its piece sends padding alone), so the k-th largest for k ≤ c is the
    whole sample's; else the sample itself (s = c)."""
    if not layout.cut_flags[i]:
        return sample, sample.shape[1]
    box, shape = layout.boxes[i], layout.shapes[i]
    strides = _sample_strides(box.shape)
    width = math.prod(-(-e // s) for e, s in zip(shape, strides))
    count = math.prod(-(-n // s) for n, s in zip(box.shape, strides))
    padded = sample.new_full((sample.shape[0], width), float("-inf"))
    if layout.owner_flags[i]:
        padded[:, :sample.shape[1]] = sample
    parts = [torch.empty_like(padded) for _ in range(torch.distributed.get_world_size(
        layout.group))]
    torch.distributed.all_gather(parts, padded, group=layout.group)
    return torch.cat(parts, dim=1), count


def _radix_passes(bits: int, width: int = 11) -> tuple[tuple[int, int], ...]:
    """(shift, width) of each digit of a ``bits``-bit key, the top first."""
    out, top = [], bits
    while top > 0:
        w = min(width, top)
        out.append((top - w, w))
        top -= w
    return tuple(out)


def group_kth_largest(keys, rank: torch.Tensor, bits: int, group=None) -> torch.Tensor:
    """The ``rank[r]``-th largest of row r of ``keys`` (non-negative
    integers below 2^bits, ``[rows, n]``, or a sequence of such stacks whose
    rows run on one another: a tree's dtype groups) over every rank of
    ``group`` (each rank's keys the entries that count there) -> int64
    ``[rows]``. A radix select: each pass counts the candidates' next digit
    (one count over the rows of each stack), sums the counts over the group
    (an all-reduce, none without a group) and finds the digit from the top
    where the rank falls. Exact, and no host sync; the counts go into a
    zeros tensor of a fixed size (``index_add_``), so the select also runs
    on tensors whose values are not known (a shape pass)."""
    parts = [keys] if isinstance(keys, torch.Tensor) else list(keys)
    rows = parts[0].shape[0]
    dev = parts[0].device
    prefix = torch.zeros(rows, dtype=torch.int64, device=dev)
    rank = rank.to(device=dev, dtype=torch.int64).reshape(rows)
    base = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    for shift, width in _radix_passes(bits):
        bins = 1 << width
        top = shift + width
        hist = torch.zeros(rows * bins + 1, dtype=torch.int64, device=dev)
        for part in parts:
            cand = (part >> top) == (prefix >> top)[:, None]
            slot = torch.where(cand, ((part >> shift) & (bins - 1)).to(torch.int64) + base * bins,
                               rows * bins)
            one = torch.ones((), dtype=torch.int64, device=dev).expand(slot.numel())
            hist.index_add_(0, slot.reshape(-1), one)
            del cand, slot
        hist = hist[:-1]
        if group is not None:
            torch.distributed.all_reduce(hist, group=group)
        desc = hist.view(rows, bins).flip(-1)
        cum = torch.cumsum(desc, dim=1)
        j = torch.searchsorted(cum, rank[:, None]).clamp_max(bins - 1)
        rank = rank - (torch.gather(cum, 1, j) - torch.gather(desc, 1, j))[:, 0]
        prefix = prefix | ((bins - 1 - j[:, 0]) << shift)
    return prefix


def counted_columns(x: torch.Tensor, layout) -> torch.Tensor:
    """The columns of a ``[k, N]`` stack that count on this rank in a sum
    over the layout's group (``FlatLayout.counted``), one ``[k, n']`` copy;
    the stack itself on a layout that is not cut."""
    if not layout.cut:
        return x
    segs = [seg for seg, c in zip(layout.segments(x), layout.counted, strict=True) if c]
    return torch.cat(segs, dim=1) if segs else x[:, :0]


def global_threshold(za: torch.Tensor, layout, keep: torch.Tensor) -> torch.Tensor:
    """The ``keep[r]``-th largest of each whole row of a ``[k, N]`` float32
    stack of non-negative scores whose segments are cut over the layout's
    group -> ``[k]``: a radix select over the float32 bit patterns (whose
    integer order is the values' order), no row gathered."""
    bits = counted_columns(za, layout).contiguous().view(torch.int32)
    thr = group_kth_largest(bits, keep, 31, layout.group)
    return thr.to(torch.int32).view(torch.float32)


def tree_counted(x: torch.Tensor, sub, group) -> torch.Tensor:
    """The columns of dtype group ``sub``'s ``[k, N_g]`` stack that count on
    this rank in a sum over ``group``, the group its tree's cut segments
    lie over (None: none is cut): ``counted_columns`` where the group's
    own segments are cut; else the whole stack, on the group's first rank
    alone where other groups' segments are cut (every rank holds it
    alike)."""
    if sub.cut:
        return counted_columns(x, sub)
    if group is not None and torch.distributed.get_rank(group) != 0:
        return x[:, :0]
    return x


def grouped_topk_masks(scores, layout, rate: float | None = None,
                       rates: torch.Tensor | None = None) -> tuple:
    """Global top-k over a tree of mixed dtypes (``GroupedLayout``): one
    threshold a row over every group's float32 ``|scores|`` (``[k, N_g]``
    each), the ``num_keep(N, rate)``-th largest of the whole tree's N
    entries (or each row's at its rate of ``rates``, the dynamic path), as
    the reference concatenates the leaves -> one float32 {0,1} mask per
    group. The groups' rows concatenated and selected as a one-group
    layout's are (``torch.topk``, or the dynamic path's sort); over a
    layout cut across a group of ranks, a radix select over the groups' bit
    patterns with the bin counts summed over it, no row concatenated or
    gathered."""
    za = [torch.abs(z).float() for z in scores]
    rows, dev = za[0].shape[0], za[0].device
    n, group = layout.full_total, layout.group
    if group is None:
        cat = torch.cat(za, dim=1)
        thr = (exact_threshold(cat, num_keep(n, rate)) if rates is None
               else dynamic_threshold(cat, num_keep_dynamic(n, rates)))
        del cat
    else:
        keep = (torch.full((rows,), num_keep(n, rate), dtype=torch.int64, device=dev)
                if rates is None else num_keep_dynamic(n, rates))
        keys = [tree_counted(z, sub, group).contiguous().view(torch.int32)
                for z, sub in zip(za, layout.groups, strict=True)]
        thr = group_kth_largest(keys, keep, 31, group).to(torch.int32).view(torch.float32)
    return tuple((z >= thr[:, None]).float() for z in za)


def _bcast(thr: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return thr.reshape((thr.shape[0],) + (1,) * (like.dim() - 1))


def topk_mask(z: torch.Tensor, rate: float, selector: str = "exact", layout=None) -> torch.Tensor:
    """{0,1} float32 mask keeping ~``rate`` of each client's largest ``|z|``.
    A flat ``[k, N]`` stack of a ``layout`` cut over a group selects over
    the whole rows (exact selector)."""
    za = torch.abs(z).float()
    if layout is not None and layout.cut and selector == "exact":
        keep = torch.full((za.shape[0],), num_keep(layout.full_total, rate), dtype=torch.int64,
                          device=za.device)
        return (za >= global_threshold(za, layout, keep)[:, None]).float()
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
    if layout.shared_flags[i]:  # every rank's owner flag, from the layout's places
        parts = [p for p, (owners, _) in zip(parts, layout.places, strict=True) if owners[i]]
    return torch.cat(parts, dim=1)


def segment_thresholds(za: torch.Tensor, layout, rate: float,
                       selector: str = "exact") -> torch.Tensor:
    """The threshold of every (client, leaf) segment of a flat ``[k, N]``
    score stack -> ``[k, L]``: the exact k_i-th largest of the segment (of
    the whole leaf where it is cut over the layout's model group, the plain
    version of ``gmf_select``'s group mode), or the sampled estimate from a
    strided sample of the (whole) leaf in its shape."""
    out = []
    keep, _ = layout.keep(rate)
    for i, (seg, k_i) in enumerate(zip(layout.segments(za), keep, strict=True)):
        if selector == "exact":
            out.append(exact_threshold(whole_segment(seg, layout, i), k_i))
        elif selector == "sampled":
            sample, count = whole_sample(segment_sample(seg, layout, i), layout, i)
            out.append(exact_threshold(sample, num_keep(count, rate)))
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
    ``[k]`` (of the whole leaves' sizes) -> int64 ``[k, L]`` on the rates'
    device."""
    return num_keep_dynamic(layout.full_sizes_dev.to(rates.device)[None, :], rates[:, None])


def dynamic_threshold(z_rows: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The ``k[r]``-th largest value of each row of ``z_rows`` (``[rows, n]``,
    ``k`` int64 ``[rows]``) -> ``[rows]``: one descending sort per row and a
    gather, as the reference's ``dynamic_threshold``."""
    ordered = torch.sort(z_rows, dim=1, descending=True).values
    return torch.gather(ordered, 1, (k - 1).reshape(-1, 1))[:, 0]


def segment_keep_thresholds(za: torch.Tensor, layout, keep: torch.Tensor) -> torch.Tensor:
    """The ``keep[r, i]``-th largest of every (client, leaf) segment of a
    flat ``[k, N]`` score stack (of the whole leaf where it is cut) -> ``[k,
    L]``: the plain version of the kernel's per-row keep table."""
    return torch.stack([dynamic_threshold(whole_segment(seg, layout, i), keep[:, i])
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
    for i, seg in enumerate(layout.segments(za)):
        sample, count = whole_sample(segment_sample(seg, layout, i), layout, i)
        thr.append(dynamic_threshold(sample, num_keep_dynamic(count, rates)))
    return (za >= layout.expand(torch.stack(thr, dim=1))).float()


def topk_mask_dynamic(z: torch.Tensor, rates: torch.Tensor, layout=None) -> torch.Tensor:
    """One exact threshold per client over its whole row at its own rate
    (global top-k, ``per_tensor=False``) -> the {0,1} mask; over the whole
    rows where the ``[k, N]`` stack's layout is cut over a group."""
    za = torch.abs(z).float().reshape(z.shape[0], -1)
    if layout is not None and layout.cut:
        thr = global_threshold(za, layout, num_keep_dynamic(layout.full_total, rates))
    else:
        thr = dynamic_threshold(za, num_keep_dynamic(za.shape[1], rates))
    return (za >= thr[:, None]).float().reshape(z.shape)
