"""K1, K10 and K4: slab-causal flash attention with in-kernel RoPE, forward
(bf16 or int8 QK scores) and backward.

- K1 replaces ``frankenstein_tpu/ops/pallas/block_attention.py:
  _fwd_packed_rope_bte``; CUDA C++ in ``csrc/slab_rope_attention_fwd.cu``.
  A pre-pass rotates q and k once into a workspace (the rotation K4's
  pre-pass runs), then a forward runs on a TMA ring and wgmma (the blocks
  of ``csrc/hopper_blocks.cuh``) on K4's slab schedule, in an unmasked
  instance where the slab length is a multiple of 64 (the key tile and a
  warpgroup's rows) and a masked one for any other.
- K10 is the JAX kernel's ``qk_int8=True`` mode: rotated Q quantized per
  (row, head) and rotated K per (1024-row chunk, head) to int8, the QK dot
  in int8, dequantized in the convert; V and AV stay bf16. A pre-pass
  rotates and quantizes K, another Q, then K1's forward with its score
  product in int8 wgmma runs on their codes
  (``csrc/slab_rope_attention_int8.cu``).
- K4 replaces ``block_attention.py:_slab_rope_attention_bwd``: its XLA
  rotations, ``_bwd_packed`` (or the per-head ``_bwd``) and the rotations
  back; CUDA C++ in ``csrc/slab_rope_attention_bwd.cu``. A pre-pass rotates
  q and k once and takes delta, then a dq pass and a dk/dv pass run on TMA
  rings and wgmma (the blocks of ``csrc/hopper_blocks.cuh``) and rotate dq
  and dk back in their epilogues. After K10 it runs on K10's out and lse,
  as the JAX package's backward does.

Each source note says what bounds the kernel on an H100 and how the design
answers that. ``SlabRopeAttention`` is the autograd Function around them:
forward K1 or K10 (saving the unrotated q, k, v, out and lse), backward K4.

``slab_rope_attention`` and ``slab_rope_attention_bwd`` launch the kernels
for CUDA tensors and run the plain PyTorch twins (``*_ref``) for CPU
tensors. They never fall back from one to the other: a CUDA input a kernel
does not take raises. ``supported`` says which inputs they take;
``models/layers.py:SelfAttention`` consults it and runs the plain path
(``apply_rope`` + ``dot_product_attention``) where it says no.
"""

from __future__ import annotations

import ctypes

import torch

from frankenstein_tpu_torch.ops import rope
from frankenstein_tpu_torch.ops.cuda import build

KCHUNK = 1024      # rows per K10 key scale (the JAX pack plan's chunk)

launches = 0       # wrapper calls that ran K1
launches_int8 = 0  # wrapper calls that ran K10 (its pre-pass and kernel)
launches_bwd = 0   # wrapper calls that ran K4 (its pre-pass and both passes)
FWD_PASSES = {"prep": 0, "fwd": 1}            # fwd(_int8)_occupancy's
BWD_PASSES = {"prep": 0, "dq": 1, "dkv": 2}   # bwd_occupancy's passes


def _absmax_codes(x, dims):
    """K10's symmetric int8 quantization over ``dims`` (kept): (codes, s)
    with s = max|x| / 127 + 1e-12 and codes = round_half_even(x / s), the
    codes as floats of x's dtype. The divisor 127 is a full tensor: PyTorch
    on CUDA divides by a scalar as a product with its reciprocal, which can
    differ from the quotient in the last bit."""
    mx = x.abs().amax(dim=dims, keepdim=True)
    s = mx / torch.full_like(mx, 127.0) + 1e-12
    return torch.round(x / s), s


def rope_quantize_k_ref(k, cos, sin, *, n_heads: int):
    """Plain twin of K10's pre-pass: k [B, T, E] rotated
    (``apply_rope_folded``, rounded to k's dtype) and quantized per
    (1024-row chunk, head). Returns (codes [B, T, E] int8, scales
    [B, H, T / 1024] f32)."""
    b, t, e = k.shape
    d = e // n_heads
    cos_e, sin_e = cos.repeat(1, n_heads), sin.repeat(1, n_heads)
    kr = rope.apply_rope_folded(k, cos_e, sin_e).float()
    codes, s = _absmax_codes(
        kr.reshape(b, t // KCHUNK, KCHUNK, n_heads, d), (2, 4))
    return (codes.reshape(b, t, e).to(torch.int8),
            s.reshape(b, t // KCHUNK, n_heads).transpose(1, 2).contiguous())


def rope_quantize_q_ref(q, cos, sin, *, n_heads: int):
    """Plain twin of K10's Q pre-pass: q [B, T, E] rotated
    (``apply_rope_folded``, rounded to q's dtype) and quantized per (row,
    head). Returns (codes [B, T, E] int8, scales [B, H, T] f32)."""
    b, t, e = q.shape
    cos_e, sin_e = cos.repeat(1, n_heads), sin.repeat(1, n_heads)
    qr = rope.apply_rope_folded(q, cos_e, sin_e).float()
    codes, s = _absmax_codes(qr.reshape(b, t, n_heads, e // n_heads), (3,))
    return (codes.reshape(b, t, e).to(torch.int8),
            s[..., 0].transpose(1, 2).contiguous())


def _slab_rope_attention_ref(q, k, v, cos, sin, n_heads: int,
                             tok_per_time: int, qk_int8: bool):
    """K1's twin, or with ``qk_int8`` K10's: the scores of each query slab
    are ``(dot(q8, k8) * (scale * s_k)) * s_q`` on the codes of
    ``_absmax_codes`` (integer-valued, so their f32 sums are exact)."""
    b, t, e = q.shape
    d = e // n_heads
    scale = 1.0 / float(d) ** 0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    cos_e, sin_e = cos.repeat(1, n_heads), sin.repeat(1, n_heads)
    heads = lambda x: x.reshape(b, t, n_heads, d)
    qr = heads(rope.apply_rope_folded(q, cos_e, sin_e).to(acc))
    if qk_int8:
        qr, s_q = _absmax_codes(qr, (3,))
        s_q = s_q[..., 0].transpose(1, 2)                     # [B, H, T]
        k8, s_k = rope_quantize_k_ref(k, cos, sin, n_heads=n_heads)
        kr = heads(k8.to(acc))
        s_k = (scale * s_k.to(acc)).repeat_interleave(KCHUNK, dim=-1)
    else:
        kr = heads(rope.apply_rope_folded(k, cos_e, sin_e).to(acc))
    vf = heads(v)
    out = torch.empty(b, t, n_heads, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, n_heads, t, dtype=acc, device=q.device)
    for r0 in range(0, t, tok_per_time):
        r1 = min(t, r0 + tok_per_time)
        logits = torch.einsum("bqhd,bkhd->bhqk", qr[:, r0:r1], kr[:, :r1])
        if qk_int8:
            logits = (logits * s_k[:, :, None, :r1]) * s_q[:, :, r0:r1, None]
        else:
            logits = logits * scale
        lse[:, :, r0:r1] = torch.logsumexp(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1).to(v.dtype).to(acc)
        out[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", probs,
                                     vf[:, :r1].to(acc)).to(q.dtype)
    return out.reshape(b, t, e), lse


def slab_rope_attention_ref(q, k, v, cos, sin, *, n_heads: int,
                            tok_per_time: int):
    """Plain PyTorch twin of K1: ``apply_rope_folded`` (the kernel's
    expression: x*cos + (-x_odd | x_even)*sin in f32, rounded to the input
    dtype), then slab-masked softmax attention, one query slab at a time (no
    T x T score matrix). Accumulates in f32 (f64 for f64 input).

    q, k, v: [B, T, E]; cos, sin: [T, D] f32. Returns (out [B, T, E] in q's
    dtype, lse [B, H, T] f32)."""
    return _slab_rope_attention_ref(q, k, v, cos, sin, n_heads, tok_per_time,
                                    False)


def slab_rope_attention_int8_ref(q, k, v, cos, sin, *, n_heads: int,
                                 tok_per_time: int):
    """Plain PyTorch twin of K10, the JAX kernel's ``qk_int8`` arithmetic:
    rotated q (rounded to q's dtype) quantized per (row, head), rotated k
    per (1024-row chunk, head) (``rope_quantize_k_ref``), scores
    ``(dot(q8, k8) * (scale * s_k)) * s_q``, then K1's softmax and AV.
    T % 1024 == 0. Returns (out, lse) as ``slab_rope_attention_ref``."""
    return _slab_rope_attention_ref(q, k, v, cos, sin, n_heads, tok_per_time,
                                    True)


def slab_rope_fwd_prep_ref(q, k, cos, sin, *, n_heads: int):
    """Plain twin of K1's pre-pass: q and k [B, T, E] rotated
    (``apply_rope_folded`` with the [T, D] tables repeated over the heads,
    rounded to their dtype). Returns (qr, kr)."""
    cos_e, sin_e = cos.repeat(1, n_heads), sin.repeat(1, n_heads)
    return (rope.apply_rope_folded(q, cos_e, sin_e),
            rope.apply_rope_folded(k, cos_e, sin_e))


def slab_rope_bwd_prep_ref(q, k, cos, sin, out, dout, *, n_heads: int):
    """Plain twin of K4's pre-pass: q and k rotated as K1's pre-pass
    rotates them (``slab_rope_fwd_prep_ref``) and delta = rowsum(out *
    dout) per head, in f32 (f64 for f64 input). Returns (qr, kr [B, T, E],
    delta [B, H, T])."""
    b, t, e = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    prod = out.to(acc) * dout.to(acc)
    delta = prod.reshape(b, t, n_heads, e // n_heads).sum(-1).transpose(1, 2)
    return (*slab_rope_fwd_prep_ref(q, k, cos, sin, n_heads=n_heads), delta)


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
    qr, kr, delta = slab_rope_bwd_prep_ref(q, k, cos, sin, out, dout,
                                           n_heads=n_heads)
    qr, kr = heads(qr.to(acc)), heads(kr.to(acc))
    vf, do = heads(v).to(acc), heads(dout).to(acc)
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


def supported(device, dtype, t: int, e: int, n_heads: int,
              qk_int8: bool = False) -> bool:
    """Whether K1 and K4 take [B, T, E] q/k/v of ``dtype`` on ``device``
    with ``n_heads`` heads: on CUDA bf16, a head_dim of 32 or 64 and T % 128
    == 0 (the limits ``_check`` raises on); the CPU twins take any. With
    ``qk_int8``, whether K10 takes them: K1's limits and, on every device,
    T % 1024 == 0, since the K scale is taken per 1024-row chunk (the JAX
    package's math, not its schedule)."""
    if qk_int8 and (t <= 0 or t % KCHUNK):
        return False
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


def _check_int8(t: int) -> None:
    if t % KCHUNK:
        raise ValueError(f"T={t}: K10 needs T % {KCHUNK} == 0 (one K scale "
                         f"per {KCHUNK}-row chunk)")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def rope_quantize_k(k, cos, sin, *, n_heads: int):
    """K10's pre-pass alone: k [B, T, E] rotated and quantized per
    (1024-row chunk, head). Returns (codes [B, T, E] int8, scales
    [B, H, T / 1024] f32). The pre-pass on CUDA tensors, the twin on CPU
    tensors; ``slab_rope_attention(qk_int8=True)`` runs it before K10's
    kernel."""
    if not k.is_cuda:
        return rope_quantize_k_ref(k, cos, sin, n_heads=n_heads)
    b, t, e = k.shape
    _check(k, k, k, cos, sin, n_heads, 1)
    _check_int8(t)
    k8 = torch.empty(b, t, e, dtype=torch.int8, device=k.device)
    ks = torch.empty(b, n_heads, t // KCHUNK, dtype=torch.float32,
                     device=k.device)
    amax = torch.zeros(b, n_heads, t // KCHUNK, dtype=torch.int32,
                       device=k.device)       # the chunks' max |k|, as bits
    rc = build.library().fk_slab_rope_k_quant(
        k.data_ptr(), cos.data_ptr(), sin.data_ptr(), amax.data_ptr(),
        k8.data_ptr(), ks.data_ptr(), b, t, n_heads, e // n_heads,
        _stream(k))
    build.check(rc, "slab_rope_k_quant")
    return k8, ks


def rope_quantize_q(q, cos, sin, *, n_heads: int):
    """K10's Q pre-pass alone: q [B, T, E] rotated and quantized per (row,
    head). Returns (codes [B, T, E] int8, scales [B, H, T] f32). The
    pre-pass on CUDA tensors, the twin on CPU tensors;
    ``slab_rope_attention_fwd_int8`` runs it before K10's forward."""
    if not q.is_cuda:
        return rope_quantize_q_ref(q, cos, sin, n_heads=n_heads)
    b, t, e = q.shape
    _check(q, q, q, cos, sin, n_heads, 1)
    _check_int8(t)
    q8 = torch.empty(b, t, e, dtype=torch.int8, device=q.device)
    qs = torch.empty(b, n_heads, t, dtype=torch.float32, device=q.device)
    rc = build.library().fk_slab_rope_q_quant(
        q.data_ptr(), cos.data_ptr(), sin.data_ptr(), q8.data_ptr(),
        qs.data_ptr(), b, t, n_heads, e // n_heads, _stream(q))
    build.check(rc, "slab_rope_q_quant")
    return q8, qs


def slab_rope_attention_fwd_int8(q, k8, ks, v, cos, sin, *, n_heads: int,
                                 tok_per_time: int):
    """K10 after its K pre-pass, on the codes and scales of
    ``rope_quantize_k`` (CUDA tensors only; it times K10 without the K
    pre-pass): the Q pre-pass, into a workspace dropped after the call,
    then the forward. Returns (out, lse) as ``slab_rope_attention``."""
    _check(q, q, v, cos, sin, n_heads, tok_per_time)
    b, t, e = q.shape
    _check_int8(t)
    if (k8.dtype != torch.int8 or k8.shape != q.shape
            or not k8.is_contiguous() or k8.data_ptr() % 16
            or k8.device != q.device or ks.dtype != torch.float32
            or ks.shape != (b, n_heads, t // KCHUNK)
            or not ks.is_contiguous() or ks.device != q.device):
        raise ValueError("k8, ks: need rope_quantize_k's codes and scales")
    d = e // n_heads
    q8 = torch.empty(b, t, e, dtype=torch.int8, device=q.device)
    qs = torch.empty(b, n_heads, t, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty(b, n_heads, t, dtype=torch.float32, device=q.device)
    rc = build.library().fk_slab_rope_attention_fwd_int8(
        q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), q8.data_ptr(), qs.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, t, n_heads, d, tok_per_time,
        1.0 / float(d) ** 0.5, _stream(q))
    build.check(rc, "slab_rope_attention_fwd_int8")
    return out, lse


def slab_rope_fwd_prep(q, k, cos, sin, *, n_heads: int):
    """K1's pre-pass alone: (qr, kr [B, T, E] bf16) as
    ``slab_rope_fwd_prep_ref`` gives them. The pre-pass on CUDA tensors,
    the twin on CPU tensors; ``slab_rope_attention`` runs it before its
    forward, into a workspace it drops after the call."""
    if not q.is_cuda:
        return slab_rope_fwd_prep_ref(q, k, cos, sin, n_heads=n_heads)
    _check(q, k, k, cos, sin, n_heads, 1)
    b, t, e = q.shape
    qr, kr = torch.empty_like(q), torch.empty_like(k)
    rc = build.library().fk_slab_rope_attn_fwd_prep(
        q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        qr.data_ptr(), kr.data_ptr(), b, t, n_heads, e // n_heads, _stream(q))
    build.check(rc, "slab_rope_attn_fwd_prep")
    return qr, kr


def _occupancy(entry: str, pass_: int, head_dim: int,
               tok_per_time: int) -> tuple:
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    rc = getattr(build.library(), entry)(
        pass_, head_dim, tok_per_time, ctypes.byref(regs),
        ctypes.byref(ctas))
    build.check(rc, f"{entry}[{pass_}]")
    return regs.value, ctas.value


def fwd_occupancy(pass_: str, head_dim: int, tok_per_time: int) -> tuple:
    """(registers a thread, resident CTAs an SM) of one K1 kernel ("prep",
    "fwd") at ``head_dim``, in the instance (masked or not) that
    ``tok_per_time`` takes, from the CUDA runtime."""
    return _occupancy("fk_slab_rope_attention_fwd_occupancy",
                      FWD_PASSES[pass_], head_dim, tok_per_time)


def fwd_int8_occupancy(pass_: str, head_dim: int, tok_per_time: int) -> tuple:
    """As ``fwd_occupancy``, of one K10 kernel: "prep" its Q pre-pass,
    "fwd" its forward."""
    return _occupancy("fk_slab_rope_attention_fwd_int8_occupancy",
                      FWD_PASSES[pass_], head_dim, tok_per_time)


def slab_rope_attention(q, k, v, cos, sin, *, n_heads: int,
                        tok_per_time: int, qk_int8: bool = False):
    """Slab-causal attention over UNROTATED [B, T, E] q/k/v with RoPE
    applied by the kernels. cos, sin: [T, D] f32 lane tables
    (``rope.folded_tables(rope_cache[-T:], 1)``). ``qk_int8`` runs K10 (its
    K and Q pre-passes, then its forward; T % 1024 == 0) instead of K1.
    The rotated q and k (K1) or their codes and scales (K10) are a
    workspace of the call, not kept.
    Returns (out [B, T, E], lse [B, H, T] f32)."""
    global launches, launches_int8
    if not q.is_cuda:
        ref = (slab_rope_attention_int8_ref if qk_int8
               else slab_rope_attention_ref)
        return ref(q, k, v, cos, sin, n_heads=n_heads,
                   tok_per_time=tok_per_time)
    _check(q, k, v, cos, sin, n_heads, tok_per_time)
    if qk_int8:
        k8, ks = rope_quantize_k(k, cos, sin, n_heads=n_heads)
        out, lse = slab_rope_attention_fwd_int8(
            q, k8, ks, v, cos, sin, n_heads=n_heads,
            tok_per_time=tok_per_time)
        launches_int8 += 1
        return out, lse
    b, t, e = q.shape
    d = e // n_heads
    qr, kr, out = (torch.empty_like(q) for _ in range(3))
    lse = torch.empty(b, n_heads, t, dtype=torch.float32, device=q.device)
    rc = build.library().fk_slab_rope_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), qr.data_ptr(), kr.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, t, n_heads, d, tok_per_time,
        1.0 / float(d) ** 0.5, _stream(q))
    build.check(rc, "slab_rope_attention_fwd")
    launches += 1
    return out, lse


def slab_rope_bwd_prep(q, k, cos, sin, out, dout, *, n_heads: int):
    """K4's pre-pass alone: (qr, kr [B, T, E] bf16, delta [B, H, T] f32)
    as ``slab_rope_bwd_prep_ref`` gives them. The pre-pass on CUDA tensors,
    the twin on CPU tensors; ``slab_rope_attention_bwd`` runs it before
    its two passes."""
    if not q.is_cuda:
        return slab_rope_bwd_prep_ref(q, k, cos, sin, out, dout,
                                      n_heads=n_heads)
    _check(q, k, k, cos, sin, n_heads, 1, out=out, dout=dout)
    b, t, e = q.shape
    qr, kr = torch.empty_like(q), torch.empty_like(k)
    delta = torch.empty(b, n_heads, t, dtype=torch.float32, device=q.device)
    rc = build.library().fk_slab_rope_attn_bwd_prep(
        q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        out.data_ptr(), dout.data_ptr(), qr.data_ptr(), kr.data_ptr(),
        delta.data_ptr(), b, t, n_heads, e // n_heads, _stream(q))
    build.check(rc, "slab_rope_attn_bwd_prep")
    return qr, kr, delta


def bwd_occupancy(pass_: str, head_dim: int, tok_per_time: int) -> tuple:
    """(registers a thread, resident CTAs an SM) of one K4 pass ("prep",
    "dq", "dkv") at ``head_dim``, in the instance (masked or not) that
    ``tok_per_time`` takes, from the CUDA runtime."""
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    rc = build.library().fk_slab_rope_attention_bwd_occupancy(
        BWD_PASSES[pass_], head_dim, tok_per_time, ctypes.byref(regs),
        ctypes.byref(ctas))
    build.check(rc, f"slab_rope_attention_bwd_occupancy[{pass_}]")
    return regs.value, ctas.value


def slab_rope_attention_bwd(q, k, v, cos, sin, out, lse, dout, *,
                            n_heads: int, tok_per_time: int):
    """Gradients (dq, dk, dv) of ``slab_rope_attention`` with respect to the
    UNROTATED q, k, v, from K1's (or K10's) out and lse and the gradient
    ``dout`` of out. K4 on CUDA tensors, the twin on CPU tensors."""
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
    qr, kr, dq, dk, dv = (torch.empty_like(q) for _ in range(5))
    delta = torch.empty_like(lse)
    rc = build.library().fk_slab_rope_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        qr.data_ptr(), kr.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, t, n_heads, d, tok_per_time,
        1.0 / float(d) ** 0.5, _stream(q))
    build.check(rc, "slab_rope_attention_bwd")
    launches_bwd += 1
    return dq, dk, dv


class SlabRopeAttention(torch.autograd.Function):
    """out = slab_rope_attention(q, k, v, cos, sin, qk_int8=...): K1 or K10
    forward, K4 backward on that forward's out and lse (their twins on the
    CPU). With ``qk_int8`` the gradients are approximately straight-through,
    as in the JAX package: K4 recomputes exact scores against the quantized
    forward's out and lse. Saves the unrotated q, k, v, out and lse, as the
    JAX package's custom VJP does; cos and sin get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, n_heads: int, tok_per_time: int,
                qk_int8: bool = False):
        out, lse = slab_rope_attention(q, k, v, cos, sin, n_heads=n_heads,
                                       tok_per_time=tok_per_time,
                                       qk_int8=qk_int8)
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        ctx.n_heads, ctx.tok_per_time = n_heads, tok_per_time
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        dq, dk, dv = slab_rope_attention_bwd(
            q, k, v, cos, sin, out, lse, dout.contiguous(),
            n_heads=ctx.n_heads, tok_per_time=ctx.tok_per_time)
        return dq, dk, dv, None, None, None, None, None
