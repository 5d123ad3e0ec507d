"""The collectives the mesh steps and the expert-parallel MoE run, over
``torch.distributed`` process groups, differentiable where a gradient
crosses them (the counterparts of ``lax.psum``, ``lax.all_to_all`` and
``lax.all_gather`` inside the reference's ``shard_map`` regions).

Every rank's loss is its share of the global loss, and the global
gradient is the sum of the ranks' gradients: so the backward of a sum
over ranks is a sum over ranks of the upstream gradients, the backward of
an exchange is the reverse exchange, and the backward of a gather is each
rank's slice of the summed gradients. A group of one rank changes no bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


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
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        total = _SumOver.apply(grad, ctx.group)
        return total.chunk(size(ctx.group), dim=ctx.dim)[rank(ctx.group)], None, None


def gather_cat(x, group, dim: int):
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    return _GatherCat.apply(x, group, dim)
