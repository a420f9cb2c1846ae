"""Process groups for the (``data``, ``model``) mesh
(``frankenstein_tpu/parallel/mesh.py``).

The JAX package computes a step on the GLOBAL batch under ``jit`` and lets
XLA place the collectives. Here every rank is a process
(``torch.distributed``) and the collectives are written out:

- ``maybe_initialize_distributed`` joins the group torchrun describes in
  the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``); NCCL for a card, gloo only when the caller asks for
  the CPU. There is no fallback from one to the other.
- ``make_mesh`` builds a ``DeviceMesh`` with dimensions ("data",
  "model") over every rank; its size must be the world size.
- ``shard_batch`` takes a rank's rows of a global batch, ``replicate``
  broadcasts tensors from a group's first rank.
- ``batch_shard`` marks the forward passes inside it as one rank's share
  of a global batch split over a data group. Code that needs the global
  batch reads it through ``current_batch_shard``: a loss normalised by a
  count (the CE over kept targets) divides by the global count, the MoE
  router takes its capacity and slots from the global token order, and a
  random draw (dropout, the MAE's mask) is made for the global batch and
  sliced (``global_rows``); the VQ codebook's statistics are summed
  (``global_sum``) and its draws index the gathered rows (``global_cat``).
  A rank's loss is then ``size`` times its share
  of the global loss, so the mean over the data group that DDP and FSDP
  take of the gradients is the gradient of the global loss.
- ``copy_to_group``, ``reduce_from_group`` and ``gather_from_group`` are
  Megatron's differentiable collectives over a group whose ranks hold the
  same activations: identity forward and a summed backward, a summed
  forward and the identity backward, and a gather whose backward keeps the
  rank's own slice.
"""

from __future__ import annotations

import dataclasses
import os
from contextlib import contextmanager
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def backend_for(device_type: str) -> str:
    """"nccl" for "cuda", "gloo" for "cpu"."""
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device_type!r}")


def maybe_initialize_distributed(device_type: str = "cuda") -> int:
    """Join torchrun's process group when its environment names more than
    one rank (or any rank count, once ``MASTER_ADDR`` is set), on
    ``backend_for(device_type)``; on a card, this rank's device is
    ``LOCAL_RANK``. Returns the world size (1 without a group)."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and "MASTER_ADDR" not in os.environ:
        return 1
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend_for(device_type), init_method="env://")
    return dist.get_world_size()


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (data, model) over every rank, or None on
    one device without a process group. ``mesh_shape`` None puts every rank
    on "data". A shape whose size is not the world size raises
    ``ValueError`` with the cause."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    d, m = tuple(mesh_shape) if mesh_shape else (world, 1)
    if d * m != world:
        hint = ("" if dist.is_initialized() else
                " (no process group: start the ranks with torchrun "
                f"--nproc_per_node {d * m})")
        raise ValueError(f"mesh {(d, m)} needs {d * m} ranks, the world has "
                         f"{world}{hint}")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (d, m),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def group_of(mesh, axis: str):
    """The process group of ``axis`` that holds this rank (None without a
    mesh)."""
    return None if mesh is None else mesh[axis].get_group()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def shard_batch(batch, group, accum: int = 1):
    """This rank's rows of the global ``batch`` (a tuple of tensors, rows on
    axis 0) over ``group``. With ``accum`` microbatches each microbatch is
    split over the group, as the JAX trainer's global microbatch is: rank r
    takes rows [i*n + r*n/d, i*n + (r+1)*n/d) of microbatch i (n rows)."""
    d, r = group_size(group), group_rank(group)
    if d == 1:
        return tuple(batch)
    out = []
    for a in batch:
        rows = a.shape[0]
        if rows % (accum * d):
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{accum} microbatches over {d} ranks")
        per = rows // (accum * d)
        out.append(a.reshape(accum, d, per, *a.shape[1:])[:, r]
                   .reshape(accum * per, *a.shape[1:]))
    return tuple(out)


def replicate(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Broadcast each tensor in place from the first rank of ``group`` (the
    world when None)."""
    if not dist.is_initialized() or group_size(group) == 1:
        return
    src = dist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)


def sum_grads(params: Iterable[torch.Tensor], group) -> None:
    """Sum each tensor's ``.grad`` over ``group`` in place: where each rank
    computed the gradient of its share of the work (its rows, its
    tokens), the parameter's gradient is the sum of the shares."""
    if group_size(group) == 1:
        return
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    group: object
    rank: int
    size: int


# a plain global, not a ContextVar: a recomputed block (remat) runs its
# forward again inside the backward, on the autograd engine's thread
_SHARD: Optional[BatchShard] = None


@contextmanager
def batch_shard(group):
    """Run the forward passes inside as this rank's share of a global batch
    split evenly over ``group`` (nothing changes for a group of one)."""
    global _SHARD
    prior = _SHARD
    size = group_size(group)
    _SHARD = (BatchShard(group, group_rank(group), size) if size > 1
              else None)
    try:
        yield _SHARD
    finally:
        _SHARD = prior


def current_batch_shard() -> Optional[BatchShard]:
    return _SHARD


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the current batch shard's group, detached (``t``
    itself outside ``batch_shard``)."""
    shard = _SHARD
    t = t.detach()
    if shard is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=shard.group)
    return t


def global_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``t`` over the current batch shard's group,
    detached (``t`` itself outside ``batch_shard``)."""
    shard = _SHARD
    t = t.detach()
    if shard is None:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=shard.group)
    return t


def global_cat(t: torch.Tensor) -> torch.Tensor:
    """The rows of ``t`` from every rank of the current batch shard's group,
    concatenated in rank order on axis 0 and detached (``t`` itself outside
    ``batch_shard``): the global batch's rows, where each rank holds an
    equal share."""
    shard = _SHARD
    t = t.detach()
    if shard is None:
        return t
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t.contiguous(), group=shard.group)
    return torch.cat(parts)


def global_rows(draw, rows: int):
    """``draw(n)`` makes a tensor of n rows on axis 0. Outside
    ``batch_shard`` returns ``draw(rows)``; inside, draws the global batch's
    rows and returns this rank's ``rows`` of them, so a rank's random draws
    are the ones the one-device step makes for its samples."""
    shard = _SHARD
    if shard is None:
        return draw(rows)
    return draw(rows * shard.size)[shard.rank * rows:(shard.rank + 1) * rows]


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.size, ctx.rank = dist.get_world_size(group), dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(ctx.size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, dim=ctx.dim)[ctx.rank].contiguous(), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``group``
    (Megatron's f): ``x`` is the same on every rank and each rank's use of
    it contributes part of its gradient."""
    if group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward; identity backward (Megatron's g): the
    gradient of the sum is already the same on every rank."""
    if group_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in rank order; the
    backward keeps this rank's slice of the (replicated) gradient."""
    if group_size(group) == 1:
        return x
    return _GatherFromGroup.apply(x, group, dim)
