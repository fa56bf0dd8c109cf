"""Collectives along one axis of a mesh, with the gradients training needs.

JAX's ``shard_map`` and GSPMD insert ``psum``, ``all_gather`` and
``all_to_all`` and differentiate through them. Here an axis of a
``parallel.mesh.Mesh`` is one of two objects with the same methods, each
taking this process's shards of the axis as a list ("parts", one per shard
that lives here) and a replicated tensor as one tensor:

- ``LocalAxis``: every shard of the axis in this process, one per device of
  the axis (a device may repeat). A collective is tensor operations across
  the parts, so autograd differentiates it as it stands;
- ``GroupAxis``: one shard per rank of a ``torch.distributed`` process
  group. Each collective is an ``autograd.Function`` with Megatron's
  conjugate backward:

  ======================  ==================  ==============================
  method                  forward             backward
  ======================  ==================  ==============================
  ``copy`` (to the        identity            all-reduce (the shards' parts
  parallel region)                            of the gradient add up)
  ``reduce`` (from it)    all-reduce          identity
  ``gather``              all-gather          this rank's slice
  ``all_to_all``          all-to-all          the inverse all-to-all
  ======================  ==================  ==============================

The backward of ``reduce`` and ``gather`` is right where everything
downstream is replicated, so that every rank computes the same gradient of
the same loss: each rank then keeps the part that flows through its own
shard. ``torch.distributed.nn.functional.all_reduce`` all-reduces in its
backward too, which multiplies such a gradient by the group's size.

A data-parallel axis completes the pair: every replica computes the global
loss from gathered or reduced terms, each replica's backward gives the part
of each gradient that flows through its own rows, and ``sum_over`` adds the
replicas' parts (a sum, not a mean: the loss is already the global one).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.rank, ctx.n, ctx.dim = dist.get_rank(group), n, dim
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    """Chunk i of the leading axis goes to rank i; chunk i of the result
    came from rank i. Its own inverse."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None


class LocalAxis:
    """Every shard of a mesh axis in this process, shard i on ``devices[i]``.
    Replicated tensors live on ``devices[0]``."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.ranks = list(range(self.size))

    def copy(self, x: torch.Tensor) -> list[torch.Tensor]:
        return [x.to(d) for d in self.devices]

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The parts' sum in rank order, on the first part's device."""
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        return total

    def gather(self, parts: list[torch.Tensor], dim: int = -1) -> torch.Tensor:
        return torch.cat([p.to(parts[0].device) for p in parts], dim)

    def all_reduce(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        return self.copy(self.reduce(parts))

    def all_to_all(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """parts[i] is [size, ...] (row j for shard j); shard j receives
        [size, ...] whose row i came from shard i."""
        return [torch.stack([p[j].to(d) for p in parts]) for j, d in enumerate(self.devices)]


class GroupAxis:
    """This rank's shard of an axis whose shards are the ranks of
    ``group``, on ``device``."""

    def __init__(self, group, device):
        self.group = group
        self.size = dist.get_world_size(group)
        self.ranks = [dist.get_rank(group)]
        self.devices = [torch.device(device)]

    def copy(self, x: torch.Tensor) -> list[torch.Tensor]:
        return [_Copy.apply(x, self.group) if self.size > 1 else x]

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        (p,) = parts
        return _Reduce.apply(p, self.group) if self.size > 1 else p

    def gather(self, parts: list[torch.Tensor], dim: int = -1) -> torch.Tensor:
        (p,) = parts
        return _Gather.apply(p, self.group, dim) if self.size > 1 else p

    def all_reduce(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        return [self.reduce(parts)]

    def all_to_all(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        (p,) = parts
        return [_AllToAll.apply(p, self.group) if self.size > 1 else p]


def sum_over(group, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor summed over the ranks of ``group`` (no gradient), in one
    flattened all-reduce; the tensors as they are without a group."""
    if group is None or dist.get_world_size(group) == 1 or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at : at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out
