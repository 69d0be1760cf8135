"""The collectives of the sharded model and step (no JAX counterpart: GSPMD
inserts them there). Each takes the process group of one mesh axis
(``mesh.data_group`` / ``mesh.model_group``); None stands for an axis of one
rank, where each is the identity and issues nothing.

They are written with ``all_reduce``, ``all_gather`` and ``broadcast``
only, which both NCCL and gloo have for CUDA tensors (gloo has no
``reduce_scatter``), so both backends run the same code. Where a gradient
crosses ranks they are autograd functions:

  * ``sum_over`` — a sum over the group whose gradient is summed over the
    group too (every rank's loss depends on the sum): the global BatchNorm
    moments;
  * ``replicated_input`` / ``sum_partials`` — Megatron's pair around a
    column-parallel then row-parallel block: the identity forward with the
    gradient summed over the model group (each rank's shard sees a part of
    the input's gradient), and the sum of the partial outputs forward with
    the gradient passed through;
  * ``gather_shards`` — the shards concatenated along a dimension; the
    gradient is this rank's slice, of the gradient itself where everything
    after the gather runs alike on every rank (the loss after the
    vocabulary-sharded logits), or of its sum over the group where each
    rank uses another part (the gathered K/V stack, used head by head).

``sum_tensors_`` (in place, one flat buffer) carries no gradient: the
gradients' (and the loss') sum over the data group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd import Function

__all__ = ["sum_over", "replicated_input", "sum_partials", "gather_shards", "sum_tensors_",
           "group_size", "group_rank"]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group; its gradient is summed over the
    group as well."""
    if group is None:
        return x
    return _SumOver.apply(x, group)


class _SumOver(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def replicated_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (the same on every rank of the model group) entering sharded
    work: forward the identity, backward the sum over the group."""
    if group is None:
        return x
    return _ReplicatedInput.apply(x, group)


class _ReplicatedInput(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of each rank's partial output (a row-parallel product):
    forward the sum over the group, backward the identity."""
    if group is None:
        return x
    return _SumPartials.apply(x, group)


class _SumPartials(Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_shards(x: torch.Tensor, group, dim: int = -1,
                  sum_grad: bool = False) -> torch.Tensor:
    """The shards of the group concatenated along ``dim`` in rank order.
    Backward: this rank's slice of the gradient, or of its sum over the
    group with ``sum_grad`` (where the ranks use other parts of the
    result)."""
    if group is None:
        return x
    return _GatherShards.apply(x, group, dim % x.ndim, sum_grad)


class _GatherShards(Function):
    @staticmethod
    def forward(ctx, x, group, dim, sum_grad):
        ctx.group, ctx.dim, ctx.sum_grad, ctx.n = group, dim, sum_grad, x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = _all_reduce(g, ctx.group)
        i = group_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None, None


@torch.no_grad()
def sum_tensors_(tensors: list[torch.Tensor], group) -> None:
    """Sum each tensor over the group in place, as one flat buffer (one
    collective whatever the number of tensors)."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    torch._foreach_copy_(tensors, [p.view_as(t) for p, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])
