"""GPipe pipeline parallelism over a ``'stage'`` mesh axis (port of
``ivf_tpu/parallel/pipeline.py``).

The JAX harness is one ``lax.scan`` of ``n_micro + S - 1`` ticks in which
every device traces every stage and ``ppermute`` shifts one flat buffer
around the ring. Here rank ``s`` of the axis runs stage ``s`` alone: it
takes each microbatch from rank ``s - 1`` (stage 0 from the input), applies
its stage and sends the result to rank ``s + 1``, in microbatch order, so
the ranks fill and drain the pipe in the same ``n_micro + S - 1`` ticks.
Each receive buffer has its stage's input shape (``stage_io_shapes``,
shape propagation on ``torch.device('meta')``). The last stage
concatenates its outputs and broadcasts them, so every rank returns the
``(B, ...)`` result.

The schedule is differentiable: every send and receive is an autograd
``Function`` whose backward runs the transfer the other way (a received
activation sends its cotangent back; a sent one receives its cotangent),
so a backward from the result gives each stage's parameters their
gradients on that stage's rank and ``x`` its gradient on rank 0. The
result is one value held by every rank: its gradient is the last stage's
copy's. The backward passes the microbatches back in reverse order on
every rank (autograd runs the latest node first).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ivf_tpu_torch.precision import reference_numerics_fn


class ShapeDtype(NamedTuple):
    shape: torch.Size
    dtype: torch.dtype


def i3d_stage_fns(model, n_stages: int, boundaries: Optional[Sequence[str]] = None):
    """Split an I3D into ``n_stages`` sequential stage functions (the JAX
    package's cut: trunk endpoints in contiguous groups of near-equal
    count, or ``boundaries``, the ``n_stages - 1`` endpoints each stage
    ends at; the last stage runs the rest of the trunk and the Logits
    head, ``I3D.head_from``)."""
    from ivf_tpu_torch.models.i3d import TRUNK_ENDPOINTS

    if not 2 <= n_stages <= len(TRUNK_ENDPOINTS):
        raise ValueError(f"n_stages={n_stages}: 2 to {len(TRUNK_ENDPOINTS)}")
    if boundaries is None:
        n = len(TRUNK_ENDPOINTS)
        cuts = [TRUNK_ENDPOINTS[math.ceil(n * (i + 1) / n_stages) - 1] for i in range(n_stages - 1)]
    else:
        cuts = list(boundaries)
        if len(cuts) != n_stages - 1 or not all(c in TRUNK_ENDPOINTS for c in cuts):
            raise ValueError(f"boundaries {cuts}: {n_stages - 1} trunk endpoints")
    fns = []
    for s in range(n_stages):
        start = None if s == 0 else cuts[s - 1]
        if s < n_stages - 1:
            fns.append(reference_numerics_fn(lambda x, a=start, b=cuts[s]: model._walk_trunk(x, a, b)))
        else:
            fns.append(lambda x, a=start: model.head_from(x, a))
    return fns


def stage_io_shapes(stage_fns, x_shape, dtype=torch.float32) -> list:
    """Each stage's input shape and dtype (index 0 the pipeline's input
    microbatch), then the output's: the stages run on meta tensors."""
    x = torch.empty(tuple(x_shape), dtype=dtype, device="meta")
    shapes = [ShapeDtype(x.shape, x.dtype)]
    with torch.no_grad():
        for fn in stage_fns:
            x = fn(x)
            shapes.append(ShapeDtype(x.shape, x.dtype))
    return shapes


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, shape, dtype, src: int, group):
        ctx.src, ctx.group = src, group
        buf = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(buf, src=src, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), dst=ctx.src, group=ctx.group)
        return None, None, None, None, None


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dst: int, group):
        ctx.dst, ctx.group, ctx.like = dst, group, (y.shape, y.dtype, y.device)
        dist.send(y.contiguous(), dst=dst, group=group)
        return y.new_zeros(())  # a token that ties the send into the result's graph

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.like
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(g, src=ctx.dst, group=ctx.group)
        return g, None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, src: int, group, *tokens):
        ctx.is_src, ctx.n_tokens = dist.get_rank() == src, len(tokens)
        buf = out.contiguous().clone()
        dist.broadcast(buf, src=src, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        return (g if ctx.is_src else None, None, None, *([zero] * ctx.n_tokens))


def pipeline_apply(
    stage_fns: Sequence[Callable],
    x: torch.Tensor,
    mesh,
    n_micro: Optional[int] = None,
    axis: str = "stage",
) -> torch.Tensor:
    """``x`` (B, ...), the same on every rank, through ``stage_fns[0]``
    ... ``stage_fns[-1]`` pipelined over ``mesh``'s ``axis``, one stage a
    rank, in ``n_micro`` microbatches (default: one a stage). Returns the
    (B, ...) result on every rank: the sequential composition's, up to
    the float reassociation of a microbatch's shapes."""
    group = mesh.get_group(axis)
    n_stages, stage = dist.get_world_size(group), dist.get_rank(group)
    if len(stage_fns) != n_stages:
        raise ValueError(f"{len(stage_fns)} stage functions for a {n_stages}-rank '{axis}' axis")
    n_micro = n_micro or n_stages
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"a batch of {b} does not split into {n_micro} microbatches")
    mb = b // n_micro
    shapes = stage_io_shapes(stage_fns, (mb, *x.shape[1:]), x.dtype)
    rank_of = [dist.get_global_rank(group, s) for s in range(n_stages)]
    fn, last = stage_fns[stage], stage == n_stages - 1
    anchor = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled())
    outs, tokens = [], []
    for m in range(n_micro):
        if stage == 0:
            act = x[m * mb : (m + 1) * mb]
        else:
            act = _Recv.apply(anchor, shapes[stage].shape, shapes[stage].dtype, rank_of[stage - 1], group)
        y = fn(act)
        if last:
            outs.append(y)
        else:
            tokens.append(_Send.apply(y, rank_of[stage + 1], group))
    final = shapes[-1]
    if last:
        out = torch.cat(outs)
    else:
        out = torch.empty((b, *final.shape[1:]), dtype=final.dtype, device=x.device)
    return _Broadcast.apply(out, rank_of[-1], group, *tokens)
