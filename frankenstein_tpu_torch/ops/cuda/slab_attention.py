"""K1 and K4: slab-causal flash attention with in-kernel RoPE, forward and
backward.

- K1 replaces ``frankenstein_tpu/ops/pallas/block_attention.py:
  _fwd_packed_rope_bte``; CUDA C++ in ``csrc/slab_rope_attention.cu``.
- K4 replaces ``block_attention.py:_bwd_packed`` (and the per-head ``_bwd``),
  reached from ``_slab_rope_attention_bwd``; CUDA C++ in
  ``csrc/slab_rope_attention_bwd.cu``. Delta and the rotations of q/k and
  back of dq/dk run inside it.

Each source note says what bounds the kernel on an H100 and how the design
answers that. ``SlabRopeAttention`` is the autograd Function around them:
forward K1 (saving the unrotated q, k, v, out and lse), backward K4.

``slab_rope_attention`` and ``slab_rope_attention_bwd`` launch the kernels
for CUDA tensors and run the plain PyTorch twins (``*_ref``) for CPU
tensors. They never fall back from one to the other: a CUDA input a kernel
does not take raises. ``supported`` says which inputs they take;
``models/layers.py:SelfAttention`` consults it and runs the plain path
(``apply_rope`` + ``dot_product_attention``) where it says no.
"""

from __future__ import annotations

import torch

from frankenstein_tpu_torch.ops import rope
from frankenstein_tpu_torch.ops.cuda import build

launches = 0       # wrapper calls that ran K1
launches_bwd = 0   # wrapper calls that ran K4


def slab_rope_attention_ref(q, k, v, cos, sin, *, n_heads: int,
                            tok_per_time: int):
    """Plain PyTorch twin of the kernel: ``apply_rope_folded`` (the
    kernel's expression: x*cos + (-x_odd | x_even)*sin in f32, rounded to
    the input dtype), then slab-masked softmax attention, one query slab at
    a time (no T x T score matrix). Accumulates in f32 (f64 for f64 input).

    q, k, v: [B, T, E]; cos, sin: [T, D] f32. Returns (out [B, T, E] in q's
    dtype, lse [B, H, T] f32)."""
    b, t, e = q.shape
    d = e // n_heads
    scale = 1.0 / float(d) ** 0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    cos_e, sin_e = cos.repeat(1, n_heads), sin.repeat(1, n_heads)
    heads = lambda x: x.reshape(b, t, n_heads, d)
    qr = heads(rope.apply_rope_folded(q, cos_e, sin_e).to(acc))
    kr = heads(rope.apply_rope_folded(k, cos_e, sin_e).to(acc))
    vf = heads(v)
    out = torch.empty(b, t, n_heads, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, n_heads, t, dtype=acc, device=q.device)
    for r0 in range(0, t, tok_per_time):
        r1 = min(t, r0 + tok_per_time)
        logits = torch.einsum("bqhd,bkhd->bhqk", qr[:, r0:r1],
                              kr[:, :r1]) * scale
        lse[:, :, r0:r1] = torch.logsumexp(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1).to(v.dtype).to(acc)
        out[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", probs,
                                     vf[:, :r1].to(acc)).to(q.dtype)
    return out.reshape(b, t, e), lse


def slab_rope_attention_bwd_ref(q, k, v, cos, sin, out, lse, dout, *,
                                n_heads: int, tok_per_time: int):
    """Plain PyTorch twin of K4, one query slab at a time (no T x T matrix):
    the JAX package's ``_bwd_packed`` math on rotated q/k (rounded as the
    forward rounded them), ds rounded to the input dtype before its
    products, p rounded to v's dtype before dv, dq/dk rounded to the input
    dtype and then rotated back by R(-theta) (``apply_rope_folded`` with
    -sin). Accumulates in f32 (f64 for f64 input).

    Returns (dq, dk, dv), [B, T, E] each, in the inputs' dtypes."""
    b, t, e = q.shape
    d = e // n_heads
    scale = 1.0 / float(d) ** 0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    cos_e, sin_e = cos.repeat(1, n_heads), sin.repeat(1, n_heads)
    heads = lambda x: x.reshape(b, t, n_heads, d)
    qr = heads(rope.apply_rope_folded(q, cos_e, sin_e).to(acc))
    kr = heads(rope.apply_rope_folded(k, cos_e, sin_e).to(acc))
    vf, do = heads(v).to(acc), heads(dout).to(acc)
    delta = (heads(out).to(acc) * do).sum(-1).transpose(1, 2)   # [B, H, T]
    dq = torch.zeros(b, t, n_heads, d, dtype=acc, device=q.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    for r0 in range(0, t, tok_per_time):
        r1 = min(t, r0 + tok_per_time)
        s = torch.einsum("bqhd,bkhd->bhqk", qr[:, r0:r1], kr[:, :r1]) * scale
        p = torch.exp(s - lse[:, :, r0:r1, None].to(acc))
        dp = torch.einsum("bqhd,bkhd->bhqk", do[:, r0:r1], vf[:, :r1])
        ds = (p * (dp - delta[:, :, r0:r1, None]) * scale).to(q.dtype).to(acc)
        dq[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", ds, kr[:, :r1])
        dk[:, :r1] += torch.einsum("bhqk,bqhd->bkhd", ds, qr[:, r0:r1])
        dv[:, :r1] += torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).to(acc),
                                   do[:, r0:r1])
    unrot = lambda x: rope.apply_rope_folded(x.reshape(b, t, e).to(q.dtype),
                                             cos_e, -sin_e)
    return unrot(dq), unrot(dk), dv.reshape(b, t, e).to(v.dtype)


def supported(device, dtype, t: int, e: int, n_heads: int) -> bool:
    """Whether K1 and K4 take [B, T, E] q/k/v of ``dtype`` on ``device``
    with ``n_heads`` heads: on CUDA bf16, a head_dim of 32 or 64 and T % 128
    == 0 (the limits ``_check`` raises on); the CPU twins take any."""
    if torch.device(device).type != "cuda":
        return True
    return (dtype == torch.bfloat16 and n_heads > 0 and e % n_heads == 0
            and e // n_heads in (32, 64) and t > 0 and t % 128 == 0)


def _check(q, k, v, cos, sin, n_heads: int, tok_per_time: int, **more):
    b, t, e = q.shape
    for name, x in (("q", q), ("k", k), ("v", v), *more.items()):
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


def slab_rope_attention_bwd(q, k, v, cos, sin, out, lse, dout, *,
                            n_heads: int, tok_per_time: int):
    """Gradients (dq, dk, dv) of ``slab_rope_attention`` with respect to the
    UNROTATED q, k, v, from K1's out and lse and the gradient ``dout`` of
    out. K4 on CUDA tensors, the twin on CPU tensors."""
    global launches_bwd
    if not q.is_cuda:
        return slab_rope_attention_bwd_ref(q, k, v, cos, sin, out, lse, dout,
                                           n_heads=n_heads,
                                           tok_per_time=tok_per_time)
    _check(q, k, v, cos, sin, n_heads, tok_per_time, out=out, dout=dout)
    b, t, e = q.shape
    if (lse.dtype != torch.float32 or lse.shape != (b, n_heads, t)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse: need contiguous f32 [{b}, {n_heads}, {t}] "
                         f"on {q.device}")
    d = e // n_heads
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)
    rc = build.library().fk_slab_rope_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t,
        n_heads, d, tok_per_time, 1.0 / float(d) ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "slab_rope_attention_bwd")
    launches_bwd += 1
    return dq, dk, dv


class SlabRopeAttention(torch.autograd.Function):
    """out = slab_rope_attention(q, k, v, cos, sin): K1 forward, K4 backward
    (their twins on the CPU). Saves the unrotated q, k, v, out and lse, as
    the JAX package's custom VJP does; cos and sin get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, n_heads: int, tok_per_time: int):
        out, lse = slab_rope_attention(q, k, v, cos, sin, n_heads=n_heads,
                                       tok_per_time=tok_per_time)
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        ctx.n_heads, ctx.tok_per_time = n_heads, tok_per_time
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        dq, dk, dv = slab_rope_attention_bwd(
            q, k, v, cos, sin, out, lse, dout.contiguous(),
            n_heads=ctx.n_heads, tok_per_time=ctx.tok_per_time)
        return dq, dk, dv, None, None, None, None
