"""K1: slab-causal flash attention with in-kernel RoPE (forward).

Replaces ``frankenstein_tpu/ops/pallas/block_attention.py:_fwd_packed_rope_bte``
(reached from ``slab_causal_attention_rope``). The kernel is CUDA C++ in
``frankenstein_tpu_torch/csrc/slab_rope_attention.cu``; its source note says
what bounds it on an H100 and how the design answers that.

``slab_rope_attention`` launches the kernel for CUDA tensors and runs the
plain PyTorch twin ``slab_rope_attention_ref`` for CPU tensors. It never
falls back from one to the other: a CUDA input the kernel does not take
raises.
"""

from __future__ import annotations

import torch

from frankenstein_tpu_torch.ops import rope
from frankenstein_tpu_torch.ops.cuda import build

launches = 0   # wrapper calls that ran the CUDA kernel


def slab_rope_attention_ref(q, k, v, cos, sin, *, n_heads: int,
                            tok_per_time: int):
    """Plain PyTorch twin of the kernel: ``apply_rope_folded`` (the
    kernel's expression: x*cos + (-x_odd | x_even)*sin in f32, rounded to
    the input dtype), then slab-masked softmax attention, one query slab at
    a time (no T x T score matrix).

    q, k, v: [B, T, E]; cos, sin: [T, D] f32. Returns (out [B, T, E] in q's
    dtype, lse [B, H, T] f32)."""
    b, t, e = q.shape
    d = e // n_heads
    scale = 1.0 / float(d) ** 0.5
    cos_e, sin_e = cos.repeat(1, n_heads), sin.repeat(1, n_heads)
    heads = lambda x: x.reshape(b, t, n_heads, d)
    qr = heads(rope.apply_rope_folded(q, cos_e, sin_e).float())
    kr = heads(rope.apply_rope_folded(k, cos_e, sin_e).float())
    vf = heads(v)
    out = torch.empty(b, t, n_heads, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, n_heads, t, dtype=torch.float32, device=q.device)
    for r0 in range(0, t, tok_per_time):
        r1 = min(t, r0 + tok_per_time)
        logits = torch.einsum("bqhd,bkhd->bhqk", qr[:, r0:r1],
                              kr[:, :r1]) * scale
        lse[:, :, r0:r1] = torch.logsumexp(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1).to(v.dtype).float()
        out[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", probs,
                                     vf[:, :r1].float()).to(q.dtype)
    return out.reshape(b, t, e), lse


def _check(q, k, v, cos, sin, n_heads: int, tok_per_time: int):
    b, t, e = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16 or x.shape != (b, t, e):
            raise ValueError(f"{name}: need bf16 [{b}, {t}, {e}], got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: need a contiguous 16-byte-aligned "
                             "tensor")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if e % n_heads:
        raise ValueError(f"E={e} is not a multiple of n_heads={n_heads}")
    d = e // n_heads
    if d not in (32, 64):
        raise ValueError(f"head_dim {d}: the kernel takes 32 or 64")
    if t % 128:
        raise ValueError(f"T={t}: the kernel needs T % 128 == 0")
    if tok_per_time <= 0:
        raise ValueError("tok_per_time must be positive")
    for name, x in (("cos", cos), ("sin", sin)):
        if (x.dtype != torch.float32 or x.shape != (t, d)
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name}: need contiguous f32 [{t}, {d}] on "
                             f"{q.device}")


def slab_rope_attention(q, k, v, cos, sin, *, n_heads: int,
                        tok_per_time: int):
    """Slab-causal attention over UNROTATED [B, T, E] q/k/v with RoPE
    applied inside the kernel. cos, sin: [T, D] f32 lane tables
    (``rope.folded_tables(rope_cache[-T:], 1)``). Returns (out [B, T, E], lse [B, H, T] f32)."""
    global launches
    if not q.is_cuda:
        return slab_rope_attention_ref(q, k, v, cos, sin, n_heads=n_heads,
                                       tok_per_time=tok_per_time)
    _check(q, k, v, cos, sin, n_heads, tok_per_time)
    b, t, e = q.shape
    d = e // n_heads
    out = torch.empty_like(q)
    lse = torch.empty(b, n_heads, t, dtype=torch.float32, device=q.device)
    lib = build.library()
    rc = lib.fk_slab_rope_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), out.data_ptr(), lse.data_ptr(), b, t, n_heads, d,
        tok_per_time, 1.0 / float(d) ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "slab_rope_attention_fwd")
    launches += 1
    return out, lse
