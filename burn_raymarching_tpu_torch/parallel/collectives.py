"""Collectives over one mesh axis with the semantics of JAX's ``shard_map``.

Inside ``shard_map`` every value is either *replicated* over a mesh axis
(the same on every rank) or *varying* (a rank's own shard). Each rank here
runs the same program on its shard and back-propagates its own copy of the
replicated loss, so the backward of each collective must be the transpose
that ``shard_map`` gives it when it tracks which values vary:

  psum       varying → replicated, forward all-reduce SUM, backward identity
             (the cotangent of a replicated value is already the total);
  pvary      replicated → varying, forward identity, backward all-reduce
             SUM (each rank's use of a replicated value contributes a part
             of its cotangent); it marks where a replicated value that
             carries a gradient enters a shard's own computation;
  all_gather varying → replicated, backward: the rank's own slice;
  pmax       forward only: the max is detached before the reduce, as the
             JAX package detaches it (``pmax`` has no differentiation rule);
  all_to_all detached tables only.

Without ``pvary``, or with torch.distributed.nn's all-reduce (which
all-reduces again in backward), a shard's gradient comes out model-size
times too large. Where a value is read by every rank of a group there is
nothing to reduce, so the forward of psum / all_gather and the backward of
pvary are the only communication.

With the gloo backend (CPU runs, and several ranks that share one GPU,
which NCCL refuses) gloo takes only CPU tensors for most collectives: a
CUDA tensor is staged through host memory for the call. That is the
transport; every computation stays on the tensor's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One axis of a device mesh: its process group, size and this rank's
    index along it (JAX's ``axis_index``)."""

    group: object
    size: int
    index: int
    name: str = ""

    @property
    def staged(self) -> bool:
        """True when CUDA tensors go through host memory (gloo)."""
        return dist.get_backend(self.group) == "gloo"


def _to_wire(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A fresh contiguous copy to send: on the host for gloo, and bool as
    uint8 (which every backend carries)."""
    x = x.detach()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if axis.staged and x.device.type != "cpu":
        return x.cpu()
    return x.clone().contiguous()


def _from_wire(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.to(device=like.device, dtype=like.dtype)


def _all_reduce(x: torch.Tensor, axis: Axis, op) -> torch.Tensor:
    buf = _to_wire(x, axis)
    dist.all_reduce(buf, op=op, group=axis.group)
    return _from_wire(buf, x)


def _all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    buf = _to_wire(x, axis)
    parts = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(parts, buf, group=axis.group)
    return _from_wire(torch.cat(parts, dim=dim), x)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis, dist.ReduceOp.SUM), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None,
                None)


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum over the axis; the result is replicated."""
    return _PSum.apply(x, axis)


def pvary(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A replicated value as a shard's own input (identity forward)."""
    return _PVary.apply(x, axis)


@torch.no_grad()
def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Max over the axis of a detached value."""
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """The shards concatenated along ``dim`` in axis order (JAX's
    ``all_gather(..., tiled=True)``); the result is replicated."""
    return _AllGather.apply(x, axis, dim)


@torch.no_grad()
def all_to_all(x: torch.Tensor, axis: Axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's ``all_to_all(..., tiled=True)`` on a detached value: ``x`` is
    cut into ``axis.size`` blocks along ``split_dim``; rank r receives block
    r of every rank and concatenates them along ``concat_dim`` in axis
    order."""
    buf = _to_wire(x, axis)
    if axis.staged:
        # Some gloo builds have no alltoall: gather every rank's blocks and
        # keep the ones addressed to this rank (more bytes, same result).
        whole = [torch.empty_like(buf) for _ in range(axis.size)]
        dist.all_gather(whole, buf, group=axis.group)
        recv = [w.chunk(axis.size, dim=split_dim)[axis.index]
                for w in whole]
    else:
        send = [b.contiguous() for b in buf.chunk(axis.size, dim=split_dim)]
        recv = [torch.empty_like(b) for b in send]
        dist.all_to_all(recv, send, group=axis.group)
    return _from_wire(torch.cat(recv, dim=concat_dim), x)


def mean_grads(params, axis: Axis, extra: torch.Tensor):
    """Average every ``.grad`` of ``params`` over the axis in place, and
    the scalar ``extra`` (the loss) with them, in one all-reduce → the
    averaged ``extra``. The data-parallel step: every replica then takes
    the same optimizer step, and equal shard sizes make the mean of shard
    means the batch mean."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [extra.reshape(1)])
    flat = _all_reduce(flat, axis, dist.ReduceOp.SUM) / axis.size
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return flat[at].reshape(extra.shape)
