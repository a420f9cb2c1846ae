"""GPipe pipeline parallelism over a process group
(``frankenstein_tpu/parallel/pipeline.py``).

For a stack of same-shape layers: stage s of the group holds layers
[s*L/S, (s+1)*L/S) (``stage_params`` cuts them from the stacked [L, ...]
tensors). ``gpipe`` runs the JAX package's SPMD schedule with
hand-written differentiable P2P (not ``torch.distributed.pipelining``):
n_micro + S - 1 ticks, every stage computes on its state each tick (stage
0 takes microbatch t, the others what came from upstream), then every
activation moves one stage on (``batch_isend_irecv``); the last stage
finishes microbatch t - (S - 1) on tick t. Fill and drain ticks compute
values that are masked out, which is the (S - 1) / (n_micro + S - 1)
bubble. Every stage builds the same autograd graph (the masks are tensors,
not Python branches), so the backward's reverse hops pair up on every
rank, and the gradients are those of the sequential stack. The outputs are
summed from the last stage to all (a sum forward, the identity backward).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from frankenstein_tpu_torch.parallel import mesh as mesh_lib

STAGE_AXIS = "stage"


def _hop(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` ``step`` (+1 or -1) stages on round the ring of ``group``
    and return what arrives from the other side."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """The activation one stage on; the gradient one stage back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _hop(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _hop(g, ctx.group, -1), None


def gpipe(stage_fn: Callable, group, n_micro: int) -> Callable:
    """The per-rank pipelined apply over ``group`` (S stages, this rank's
    index its stage). ``stage_fn(local_params, h [mb, ...]) -> [mb, ...]``
    is this stage's slice of the network. Returns
    ``fn(local_params, x [n_micro, mb, ...]) -> y [n_micro, mb, ...]``,
    each microbatch through all stages in order, the same on every
    stage."""
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    n_stages = mesh_lib.group_size(group)

    def fn(local_params, x):
        s_idx = mesh_lib.group_rank(group)
        first = torch.tensor(s_idx == 0, device=x.device)
        last = torch.tensor(s_idx == n_stages - 1, device=x.device)
        state = torch.zeros_like(x[0])
        outs = [torch.zeros_like(x[0]) for _ in range(n_micro)]
        for t in range(n_micro + n_stages - 1):
            inject = x[min(t, n_micro - 1)]
            h = stage_fn(local_params, torch.where(first, inject, state))
            m = t - (n_stages - 1)
            if m >= 0:
                outs[m] = torch.where(last, h, outs[m])
            if n_stages > 1:
                state = _PPermute.apply(h, group)
        y = torch.stack(outs)
        return mesh_lib.reduce_from_group(
            torch.where(last, y, torch.zeros_like(y)), group)

    return fn


def pipelined_apply(stage_fn: Callable, local_params, x, n_micro: int,
                    group, data_group=None) -> torch.Tensor:
    """Split ``x`` [B, ...] into ``n_micro`` microbatches, run the pipeline
    over ``group`` and merge. With ``data_group`` (DP x PP) each data rank
    takes its rows of x first (microbatching on its own rows) and the
    output is gathered whole over the data group; each data rank's
    parameter gradients are then its rows' share, summed by
    ``mesh.sum_grads``. Returns [B, ...] on every rank."""
    b = x.shape[0]
    dp = mesh_lib.group_size(data_group)
    if (b // dp) % n_micro != 0:
        raise ValueError(f"per-data-shard batch {b}//{dp} not divisible by "
                         f"n_micro={n_micro}")
    xs = mesh_lib.shard_batch((x,), data_group)[0]
    mb = xs.shape[0] // n_micro
    ys = gpipe(stage_fn, group, n_micro)(
        local_params, xs.reshape((n_micro, mb) + xs.shape[1:]))
    ys = ys.reshape((n_micro * mb,) + ys.shape[2:])
    return mesh_lib.gather_from_group(ys, data_group, 0)


def stage_scan(layer_fn: Callable) -> Callable:
    """Lift ``layer_fn(layer_params, h) -> h`` into a stage function over
    the stage's stacked params (a dict of [L_local, ...] tensors)."""
    def stage_fn(local_params, h):
        n = next(iter(local_params.values())).shape[0]
        for i in range(n):
            h = layer_fn({k: v[i] for k, v in local_params.items()}, h)
        return h
    return stage_fn


def stage_params(stacked: dict, group) -> dict:
    """This stage's layers of a dict of stacked [L, ...] tensors: rows
    [s*L/S, (s+1)*L/S), as leaf tensors that take gradients."""
    n, s = mesh_lib.group_size(group), mesh_lib.group_rank(group)
    out = {}
    for k, v in stacked.items():
        if v.shape[0] % n:
            raise ValueError(f"{k}: {v.shape[0]} layers do not split over "
                             f"{n} stages")
        out[k] = v.detach().chunk(n)[s].clone().requires_grad_(True)
    return out
