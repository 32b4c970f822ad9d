"""Collectives over the axes of a ``DeviceMesh`` for the model-parallel
forward and backward, written on local tensors (the Megatron pattern).

The reference's GSPMD partitioner inserts these from its sharding
constraints; the port states them.  Each takes a mesh axis name (or a
tuple of names, reduced one axis after another) and is the identity
when the axis is ``None``, absent from the mesh, or of size 1, so that a
one-rank mesh runs exactly the unsharded arithmetic.

* :func:`reduce_from` — all-reduce (sum) forward, identity backward: the
  row-parallel matmul's partial sums, the vocab-parallel lookup.
* :func:`copy_to` — identity forward, all-reduce (sum) backward: where a
  tensor replicated over the axis enters a computation split over it,
  whose gradient each rank holds only in part.
* :func:`gather` — all-gather along a tensor dimension forward; the
  backward sums the gradient over the axis (an all-reduce, which gloo and
  NCCL both have) and keeps this rank's slice: FSDP's weight gather,
  whose backward is the data-parallel gradient reduction.
* :func:`all_reduce_sum` / :func:`all_reduce_max` — no gradient: counts,
  the log-sum-exp's max, the data-parallel reduction of replicated
  leaves' gradients.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str], None]


def _axes(mesh, axes: Axes) -> tuple:
    """The named axes of ``mesh`` that have more than one rank."""
    if mesh is None or axes is None:
        return ()
    names = tuple(mesh.mesh_dim_names or ())
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if a in names and mesh.size(names.index(a))
                 > 1)


def axis_size(mesh, axes: Axes) -> int:
    """Ranks along ``axes`` together (1 without them)."""
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    n = 1
    for a in _axes(mesh, axes):
        n *= mesh.size(names.index(a))
    return n


def axis_rank(mesh, axes: Axes) -> int:
    """This rank's index along ``axes`` together, the first one outermost
    (DTensor's order for a dimension split over several mesh axes)."""
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    r = 0
    for a in _axes(mesh, axes):
        md = names.index(a)
        r = r * mesh.size(md) + mesh.get_local_rank(md)
    return r


def _all_reduce(x: torch.Tensor, mesh, axes: tuple, op) -> torch.Tensor:
    x = x.contiguous().clone()
    for a in axes:
        dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes, dist.ReduceOp.SUM), None, \
            None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        group = mesh.get_group(axis)
        n = dist.get_world_size(group)
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, n
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.mesh, (ctx.axis,), dist.ReduceOp.SUM)
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, \
            None, None


def reduce_from(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    axes = _axes(mesh, axes)
    return _ReduceFrom.apply(x, mesh, axes) if axes else x


def copy_to(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    axes = _axes(mesh, axes)
    return _CopyTo.apply(x, mesh, axes) if axes else x


def gather(x: torch.Tensor, mesh, axis: str | None,
           dim: int) -> torch.Tensor:
    """``x``'s shards along ``axis`` concatenated on ``dim`` (``dim`` is
    counted on ``x``; negative counts from the end)."""
    if not _axes(mesh, axis):
        return x
    return _Gather.apply(x, mesh, axis, dim % x.dim())


@torch.no_grad()
def all_reduce_sum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    axes = _axes(mesh, axes)
    return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM) if axes else x


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    axes = _axes(mesh, axes)
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MAX) if axes else x
