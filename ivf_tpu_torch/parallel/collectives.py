"""The collectives the port writes out where XLA inserts them for a JAX
mesh: a differentiable sum over a process group and a differentiable
gather along one dim.

``all_reduce_sum(x, group)`` is the sum of ``x`` over the ranks of
``group``, on every rank; its backward sums the cotangent the same way, so
a value that every rank computes from the sum (the synchronised BatchNorm
statistics) sends each rank the gradient of every rank's use of it.

``all_gather_along(x, dim, group)`` concatenates the ranks' ``x`` along
``dim`` in group-rank order, on every rank. What follows the gather is
computed alike on every rank of the group, so each rank's cotangent of
the whole is the whole cotangent, and the backward keeps this rank's
slice of it. Dim 0 rebuilds a batch split over the data axis
(``find_masks``, ``evaluate``); the channel dim rebuilds a layer split over
the model axis (``mesh.tensor_parallel``).

Both call ``torch.distributed`` and need its process group: without one
they raise, as ``torch.distributed`` does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (the default group when None)."""
    return _AllReduceSum.apply(x, group)


class _AllGatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        start = dist.get_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


def all_gather_along(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along ``dim``; every rank's
    ``x`` has the same shape."""
    return _AllGatherAlong.apply(x, dim % x.dim(), group)
