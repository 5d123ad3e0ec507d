"""The collectives the mesh steps and the expert-parallel MoE run, over
``torch.distributed`` process groups, differentiable where a gradient
crosses them (the counterparts of ``lax.psum``, ``lax.all_to_all`` and
``lax.all_gather`` inside the reference's ``shard_map`` regions).

Every rank's loss is its share of the global loss, and the global
gradient is the sum of the ranks' gradients: so the backward of a sum
over ranks is a sum over ranks of the upstream gradients, the backward of
an exchange is the reverse exchange, and the backward of a gather is each
rank's slice of the summed gradients. A group of one rank changes no bit.

Tensor parallelism over a model group has the other convention, Megatron's:
every rank of the group holds the same loss, a replicated activation's
gradient is the same on every rank, and a feature-split one's is the
rank's slice. Its four operators (``copy_to``, ``reduce_from``,
``gather_from``, ``slice_to``) are each other's transposes; on a group of
one they return their input itself, forward and backward, with no copy and
no collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def _all_gather(x, group, dim):
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _SumOver.apply(grad, ctx.group), None


def sum_over(x, group):
    """The sum of ``x`` over the ranks of ``group``, a new tensor."""
    return _SumOver.apply(x, group)


def mean_over(x, groups):
    """The mean of ``x`` over the ranks of every group in ``groups`` (one
    sum a group, innermost first)."""
    n = 1
    for g in groups:
        x = sum_over(x, g)
        n *= size(g)
    return x / n if n > 1 else x


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _Exchange.apply(grad, ctx.group), None


def exchange(x, group):
    """``all_to_all`` of ``x``'s dim 0 cut into one equal chunk a rank:
    chunk j goes to rank j, and the result's chunk j came from rank j."""
    return _Exchange.apply(x, group)


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        total = _SumOver.apply(grad, ctx.group)
        return total.chunk(size(ctx.group), dim=ctx.dim)[rank(ctx.group)], None, None


def gather_cat(x, group, dim: int):
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    return _GatherCat.apply(x, group, dim)


class _ClientGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sink, key):
        ctx.sink, ctx.key = sink, key
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        sink, key = ctx.sink, ctx.key
        sink[key] = grad if key not in sink else sink[key] + grad
        return None, None, None, None, None


def fsdp_gather(x, group, dim: int, sink=None, key=None):
    """A param's FSDP pieces made whole along ``dim`` (every rank's piece in
    rank order), just before a layer uses it. Without ``sink`` it is
    ``gather_cat``: the backward sums the ranks' gradients and gives each
    rank its slice (a reduce-scatter), the gradient of the ranks' summed
    shares of one loss (dense sync, and a pod's data ranks under gmf_pod).
    With ``sink`` (a dict) each rank is its own client and needs its own
    whole gradient: the backward writes it to ``sink[key]`` (summed over
    the uses of one key), takes no collective and gives ``x`` none. Both
    are plain autograd nodes, so a checkpoint that recomputes the forward
    gathers again instead of keeping the whole leaf."""
    if sink is None:
        return gather_cat(x, group, dim)
    return _ClientGather.apply(x, group, dim, sink, key)


# ---------------------------------------------------------------------------
# Tensor parallelism (Megatron's operators over a model group)
# ---------------------------------------------------------------------------


def _alone(group) -> bool:
    return group is None or size(group) == 1


def _all_reduce(x, group):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out




def _own(x, group, dim):
    return x.chunk(size(group), dim=dim)[rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own(grad, ctx.group, ctx.dim), None, None


class _SliceTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.group, ctx.dim), None, None


def copy_to(x, group):
    """A replicated activation entering a column-parallel product: ``x``
    itself forward, its gradient all-reduced over ``group`` backward."""
    return x if _alone(group) else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """The sum over ``group`` of the ranks' partial results (a row-parallel
    product): all-reduced forward, the gradient as it is backward."""
    return x if _alone(group) else _ReduceFrom.apply(x, group)


def gather_from(x, group, dim: int):
    """A feature-split activation made whole: every rank's piece
    concatenated along ``dim`` in rank order forward, the rank's own slice
    of the gradient backward."""
    return x if _alone(group) else _GatherFrom.apply(x, group, dim)


def slice_to(x, group, dim: int):
    """This rank's slice along ``dim`` of a replicated tensor (an
    activation or a replicated leaf read per channel): the slice forward,
    the ranks' slices of the gradient gathered backward."""
    return x if _alone(group) else _SliceTo.apply(x, group, dim)


def max_over(x, group):
    """The elementwise maximum over ``group``, a new tensor, no gradient."""
    if _alone(group):
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
