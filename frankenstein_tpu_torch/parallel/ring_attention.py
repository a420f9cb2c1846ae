"""Ring attention: sequence parallelism over a process group
(``frankenstein_tpu/parallel/ring_attention.py``).

Each rank holds a [B, T/n, H, D] slice of q, k and v. The K/V blocks go
round the ring (``batch_isend_irecv`` to the next rank, from the previous)
while the local queries accumulate an f32 online softmax; after n hops
every query has seen every key, and no rank holds more than a
[B, H, T/n, T/n] block of scores. Masks come from GLOBAL positions, so the
sharding does not show in the math: full, causal (q_pos >= k_pos) and
slab-causal (q_pos // slab >= k_pos // slab, the encoder's rule). A row
that has seen nothing visible yet keeps m = -inf and takes no weight.

``RingAttention`` is a ``torch.autograd.Function`` (``jax.grad`` derives
the JAX package's backward from its scan; here it is written out): the
backward goes round the ring again, recomputing each block's probabilities
from the saved log-sum-exp, and each K/V block's gradients travel with it
and come home after n hops.

Callers: ``ring_attention_sharded`` (global q, k, v on every rank, the
output gathered), ``models/layers.py:SelfAttention(ring=group)`` and the
encoder's ``seq_parallel`` mode under ``seq_group`` (the counterpart of an
ambient JAX mesh with a "seq" axis). A hop's attention is plain torch, as
the JAX package's is: the ring never reaches kernel K1.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import torch
import torch.distributed as dist

from frankenstein_tpu_torch.parallel import mesh as mesh_lib

NEG_INF = float(torch.finfo(torch.float32).min)

_SEQ_GROUP = None


@contextmanager
def seq_group(group):
    """Make ``group`` the ambient sequence group: an encoder with
    ``seq_parallel`` inside shards its tokens over it."""
    global _SEQ_GROUP
    prior = _SEQ_GROUP
    _SEQ_GROUP = group
    try:
        yield group
    finally:
        _SEQ_GROUP = prior


def ambient_seq_group():
    """The group of the enclosing ``seq_group``, or None."""
    return _SEQ_GROUP


def _block_mask(q_pos, k_pos, causal: bool, slab: Optional[int]):
    """[Tq, Tk] bool allow-mask from global positions (None: full)."""
    if slab is not None:
        return (q_pos[:, None] // slab) >= (k_pos[None, :] // slab)
    if causal:
        return q_pos[:, None] >= k_pos[None, :]
    return None


def _ring_pass(tensors, group):
    """Send each tensor to the next rank of ``group`` and return what the
    previous rank sent."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), nxt, group)
            for t in tensors]
           + [dist.P2POp(dist.irecv, o, prv, group) for o in out])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _scores(qf, kb, q_pos, src, t_loc, causal, slab):
    """(scaled f32 scores [B, H, Tq, Tk] with masked entries at NEG_INF,
    the allow-mask or None) against the block from rank ``src``."""
    k_pos = src * t_loc + torch.arange(t_loc, device=qf.device)
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float())
    mask = _block_mask(q_pos, k_pos, causal, slab)
    if mask is not None:
        sc = sc.masked_fill(~mask, NEG_INF)
    return sc, mask


class RingAttention(torch.autograd.Function):
    """q, k, v [B, T/n, H, D] on each rank of ``group`` -> [B, T/n, H, D],
    equal to attention over the global sequence."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, slab, scale):
        b, t_loc, h, d = q.shape
        n, my = dist.get_world_size(group), dist.get_rank(group)
        q_pos = my * t_loc + torch.arange(t_loc, device=q.device)
        qf = q.float() * scale
        o = torch.zeros(b, t_loc, h, d, device=q.device)
        l = torch.zeros(b, h, t_loc, device=q.device)
        m = torch.full((b, h, t_loc), NEG_INF, device=q.device)
        kb, vb = k, v
        for s in range(n):
            sc, _ = _scores(qf, kb, q_pos, (my - s) % n, t_loc, causal, slab)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_new))
            p = torch.where(m_new[..., None] == NEG_INF, 0.0,
                            torch.exp(sc - m_new[..., None]))
            o = (o * alpha.transpose(1, 2)[..., None]
                 + torch.einsum("bhqk,bkhd->bqhd", p, vb.float()))
            l = l * alpha + p.sum(-1)
            m = m_new
            if s < n - 1:
                kb, vb = _ring_pass([kb, vb], group)
        l = torch.clamp(l, min=1e-30)
        out = o / l.transpose(1, 2)[..., None]
        lse = m + torch.log(l)                                  # [B, H, Tq]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.slab, ctx.scale = group, causal, slab, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, slab, scale = ctx.group, ctx.causal, ctx.slab, ctx.scale
        b, t_loc, h, d = q.shape
        n, my = dist.get_world_size(group), dist.get_rank(group)
        q_pos = my * t_loc + torch.arange(t_loc, device=q.device)
        qf = q.float() * scale
        do = dout.float()
        delta = (do * out).sum(-1).transpose(1, 2)              # [B, H, Tq]
        dq = torch.zeros(b, t_loc, h, d, device=q.device)
        kb, vb = k, v
        dk = torch.zeros(b, t_loc, h, d, device=q.device)
        dv = torch.zeros(b, t_loc, h, d, device=q.device)
        for s in range(n):
            sc, mask = _scores(qf, kb, q_pos, (my - s) % n, t_loc, causal,
                               slab)
            p = torch.exp(sc - lse[..., None])
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, vb.float())
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb.float()) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf)
            # the block's gradients travel with it; after the last hop one
            # more pass brings them to the rank that holds the block
            if s < n - 1:
                kb, vb, dk, dv = _ring_pass([kb, vb, dk, dv], group)
            else:
                dk, dv = _ring_pass([dk, dv], group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_attention(q, k, v, group, *, causal: bool = False,
                   slab: Optional[int] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """This rank's [B, T/n, H, D] output of attention over the global
    sequence split in rank order over ``group``."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    return RingAttention.apply(q, k, v, group, causal, slab, scale)


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, dim=dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(
            dist.get_world_size(ctx.group))]
        dist.all_gather(parts, g, group=ctx.group)
        return torch.cat(parts, dim=ctx.dim), None, None


def scatter_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` (the same on every rank) along ``dim``;
    the backward gathers the chunks' gradients, so every rank gets the
    whole of x's gradient."""
    if mesh_lib.group_size(group) == 1:
        return x
    return _ScatterToGroup.apply(x, group, dim)


def ring_attention_sharded(q, k, v, group, *, causal: bool = False,
                           slab: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Global view: q, k, v [B, T, H, D], the same on every rank of
    ``group``; the sequence splits over the group (T must divide evenly)
    and the output comes back whole, differentiably, on every rank."""
    n, t = mesh_lib.group_size(group), q.shape[1]
    if t % n != 0:
        raise ValueError(f"sequence {t} not divisible by seq group size {n}")
    parts = [scatter_to_group(a, group, 1) for a in (q, k, v)]
    out = ring_attention(*parts, group, causal=causal, slab=slab,
                         scale=scale)
    return mesh_lib.gather_from_group(out, group, 1)

