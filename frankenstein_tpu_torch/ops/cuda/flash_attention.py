"""K6 and K7: flash attention over folded [B, T, E] q/k/v with three mask
modes, forward and backward.

- ``"dense"`` (K7 unmasked) replaces ``frankenstein_tpu/ops/pallas/
  block_attention.py:dense_flash_attention``: the MAE decoder's attention
  over all 6144 tokens.
- ``"slab"`` (K7 slab-causal, no RoPE; key j visible to query i iff
  j // P <= i // P) replaces ``slab_causal_attention`` and
  ``slab_causal_attention_folded``.
- ``"positions"`` (K6; key j visible to query i iff slab_ids[j] <=
  slab_ids[i], with slab_ids = positions // P of a gathered token subset)
  replaces ``gathered_slab_attention``: the MAE encoder's attention over the
  tokens it keeps.

CUDA C++: all three modes in ``csrc/flash_attention_dense.cu``, one family
of kernels with the mask mode a compile-time parameter (TMA rings, wgmma
and warp-specialised warpgroups: a forward, a dq pass and a dk/dv pass; K6
walks a staircase taken from the slab ids, exact in any order; K7 slab the
arithmetic staircase of its slabs, with an element compare only where P is
not a multiple of the 64-row tiles), whose C entry points dispatch them.
The source note says what bounds the kernels on an H100 and how the design
answers that.
``FlashAttention`` is the autograd Function around them, saving q, k, v,
out, lse and the slab ids as the JAX package's custom VJPs do.

``flash_attention`` and ``flash_attention_bwd`` launch the kernels for CUDA
tensors and run the plain PyTorch twins (``*_ref``) for CPU tensors. They
never fall back from one to the other: a CUDA input the kernels do not take
raises. ``supported`` says which inputs they take;
``ops/attention.py:dot_product_attention`` consults it and runs its plain
path where it says no.
"""

from __future__ import annotations

import ctypes

import torch

from frankenstein_tpu_torch.ops import masks
from frankenstein_tpu_torch.ops.cuda import build

MODES = {"dense": 0, "slab": 1, "positions": 2}   # csrc/flash_mask.cuh
NEG_INF = float(torch.finfo(torch.float32).min)
TWIN_ROWS = 256   # query rows per step of the twins: no T x T matrix

launches = dict.fromkeys(MODES, 0)       # wrapper calls that ran the forward
launches_bwd = dict.fromkeys(MODES, 0)   # wrapper calls that ran the backward
# The kernels modes "dense" and "positions" launch, by symbol name
# (forward, dq, dk/dv): a profile attributes device time by these names.
DENSE_KERNELS = ("flash_attn_fwd_dense_wgmma", "flash_attn_bwd_dq_dense_wgmma",
                 "flash_attn_bwd_dkv_dense_wgmma")
POSITIONS_KERNELS = ("flash_attn_fwd_positions_wgmma",
                     "flash_attn_bwd_dq_positions_wgmma",
                     "flash_attn_bwd_dkv_positions_wgmma")
SLAB_KERNELS = ("flash_attn_fwd_slab_wgmma", "flash_attn_bwd_dq_slab_wgmma",
                "flash_attn_bwd_dkv_slab_wgmma")
PASSES = {"fwd": 0, "dq": 1, "dkv": 2}   # fk_flash_attention_occupancy


def _visible(mode: str, r0: int, r1: int, kend: int, tok_per_time: int,
             slab_ids, device):
    """[B or 1, 1, r1 - r0, kend] bool of the (query, key) pairs the mask
    lets through, or None where every pair is visible."""
    if mode == "dense":
        return None
    if mode == "slab":
        pos = torch.arange(max(r1, kend), device=device)
        return masks.block_causal_mask_from_positions(
            pos[r0:r1], pos[:kend], tok_per_time)[None, None]
    return masks.block_causal_mask_from_positions(
        slab_ids[:, r0:r1], slab_ids[:, :kend], 1)[:, None]


def _key_end(mode: str, r1: int, t: int, tok_per_time: int) -> int:
    """One past the last key any of the rows [.., r1) can see."""
    if mode == "slab":
        return min(t, ((r1 - 1) // tok_per_time + 1) * tok_per_time)
    return t


def flash_attention_ref(q, k, v, *, n_heads: int, mode: str,
                        tok_per_time: int = 0, slab_ids=None):
    """Plain PyTorch twin of the forward: masked softmax attention,
    ``TWIN_ROWS`` query rows at a time. Scores and softmax in f32 (f64 for
    f64 input), masked scores at finfo(f32).min, the probabilities rounded
    to v's dtype before the AV product.

    q, k, v: [B, T, E]. Returns (out [B, T, E] in q's dtype, lse [B, H, T]
    f32 or f64)."""
    b, t, e = q.shape
    d = e // n_heads
    scale = 1.0 / float(d) ** 0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    heads = lambda x: x.reshape(b, t, n_heads, d)
    qf, kf, vf = heads(q).to(acc), heads(k).to(acc), heads(v)
    out = torch.empty(b, t, n_heads, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, n_heads, t, dtype=acc, device=q.device)
    for r0 in range(0, t, TWIN_ROWS):
        r1 = min(t, r0 + TWIN_ROWS)
        kend = _key_end(mode, r1, t, tok_per_time)
        logits = torch.einsum("bqhd,bkhd->bhqk", qf[:, r0:r1],
                              kf[:, :kend]) * scale
        seen = _visible(mode, r0, r1, kend, tok_per_time, slab_ids,
                        q.device)
        if seen is not None:
            logits = logits.masked_fill(~seen, NEG_INF)
        lse[:, :, r0:r1] = torch.logsumexp(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1).to(v.dtype).to(acc)
        out[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", probs,
                                     vf[:, :kend].to(acc)).to(q.dtype)
    return out.reshape(b, t, e), lse


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, n_heads: int,
                            mode: str, tok_per_time: int = 0, slab_ids=None):
    """Plain PyTorch twin of the backward, ``TWIN_ROWS`` query rows at a
    time, with the JAX kernels' rounding points: p = exp(s - lse) (0 where
    masked), delta = rowsum(out * dout), ds = p * (dp - delta) * scale
    rounded to the input dtype before its products, p rounded to v's dtype
    before dv. Accumulates in f32 (f64 for f64 input).

    Returns (dq, dk, dv), [B, T, E] each, in the inputs' dtypes."""
    b, t, e = q.shape
    d = e // n_heads
    scale = 1.0 / float(d) ** 0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    heads = lambda x: x.reshape(b, t, n_heads, d).to(acc)
    qf, kf, vf, do = heads(q), heads(k), heads(v), heads(dout)
    delta = (heads(out) * do).sum(-1).transpose(1, 2)      # [B, H, T]
    dq = torch.zeros(b, t, n_heads, d, dtype=acc, device=q.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    for r0 in range(0, t, TWIN_ROWS):
        r1 = min(t, r0 + TWIN_ROWS)
        kend = _key_end(mode, r1, t, tok_per_time)
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, r0:r1], kf[:, :kend]) * scale
        p = torch.exp(s - lse[:, :, r0:r1, None].to(acc))
        seen = _visible(mode, r0, r1, kend, tok_per_time, slab_ids,
                        q.device)
        if seen is not None:
            p = p.masked_fill(~seen, 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", do[:, r0:r1], vf[:, :kend])
        ds = (p * (dp - delta[:, :, r0:r1, None]) * scale).to(k.dtype).to(acc)
        dq[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", ds, kf[:, :kend])
        dk[:, :kend] += torch.einsum("bhqk,bqhd->bkhd", ds, qf[:, r0:r1])
        dv[:, :kend] += torch.einsum("bhqk,bqhd->bkhd",
                                     p.to(dout.dtype).to(acc), do[:, r0:r1])
    fold = lambda x, like: x.reshape(b, t, e).to(like.dtype)
    return fold(dq, q), fold(dk, k), fold(dv, v)


def supported(device, dtype, t: int, e: int, n_heads: int) -> bool:
    """Whether K6 and K7 take [B, T, E] q/k/v of ``dtype`` on ``device``
    with ``n_heads`` heads, in any mode: on CUDA bf16, a head_dim of 32 or
    64 and T % 128 == 0 (the limits ``_check`` raises on); the CPU twins
    take any."""
    if torch.device(device).type != "cuda":
        return True
    return (dtype == torch.bfloat16 and n_heads > 0 and e % n_heads == 0
            and e // n_heads in (32, 64) and t > 0 and t % 128 == 0)


def _check(q, k, v, n_heads: int, mode: str, tok_per_time: int, slab_ids,
           **more):
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
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: one of {sorted(MODES)}")
    if e % n_heads:
        raise ValueError(f"E={e} is not a multiple of n_heads={n_heads}")
    if e // n_heads not in (32, 64):
        raise ValueError(f"head_dim {e // n_heads}: the kernel takes 32 or 64")
    if t % 128:
        raise ValueError(f"T={t}: the kernel needs T % 128 == 0")
    if mode == "slab" and tok_per_time <= 0:
        raise ValueError("mode 'slab' needs tok_per_time > 0")
    if mode == "positions" and (
            slab_ids is None or slab_ids.dtype != torch.int32
            or slab_ids.shape != (b, t) or not slab_ids.is_contiguous()
            or slab_ids.data_ptr() % 16 or slab_ids.device != q.device):
        raise ValueError(f"mode 'positions' needs contiguous 16-byte-aligned "
                         f"int32 slab_ids [{b}, {t}] on {q.device}")


def _launch_args(q, n_heads: int, mode: str, tok_per_time: int, slab_ids):
    b, t, e = q.shape
    d = e // n_heads
    sid = slab_ids.data_ptr() if mode == "positions" else None
    return sid, (b, t, n_heads, d, MODES[mode], tok_per_time,
                 1.0 / float(d) ** 0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention(q, k, v, *, n_heads: int, mode: str,
                    tok_per_time: int = 0, slab_ids=None):
    """Masked flash attention over [B, T, E] q/k/v (head h = columns
    [h*D, (h+1)*D), q and k already rotated). ``mode``: "dense", "slab"
    (``tok_per_time`` tokens per slab) or "positions" (``slab_ids`` [B, T]
    int32). Returns (out [B, T, E], lse [B, H, T] f32)."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, n_heads=n_heads, mode=mode,
                                   tok_per_time=tok_per_time,
                                   slab_ids=slab_ids)
    _check(q, k, v, n_heads, mode, tok_per_time, slab_ids)
    b, t, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, n_heads, t, dtype=torch.float32, device=q.device)
    sid, tail = _launch_args(q, n_heads, mode, tok_per_time, slab_ids)
    rc = build.library().fk_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sid, out.data_ptr(),
        lse.data_ptr(), *tail)
    build.check(rc, f"flash_attention_fwd ({mode})")
    launches[mode] += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, n_heads: int, mode: str,
                        tok_per_time: int = 0, slab_ids=None):
    """Gradients (dq, dk, dv) of ``flash_attention`` from its out and lse
    and the gradient ``dout`` of out. The kernels on CUDA tensors, the twin
    on CPU tensors."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       n_heads=n_heads, mode=mode,
                                       tok_per_time=tok_per_time,
                                       slab_ids=slab_ids)
    _check(q, k, v, n_heads, mode, tok_per_time, slab_ids, out=out,
           dout=dout)
    b, t, _ = q.shape
    if (lse.dtype != torch.float32 or lse.shape != (b, n_heads, t)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse: need contiguous f32 [{b}, {n_heads}, {t}] "
                         f"on {q.device}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)
    sid, tail = _launch_args(q, n_heads, mode, tok_per_time, slab_ids)
    rc = build.library().fk_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sid, out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *tail)
    build.check(rc, f"flash_attention_bwd ({mode})")
    launches_bwd[mode] += 1
    return dq, dk, dv


def slab_masked(tok_per_time: int, pass_: str, head_dim: int = 32) -> bool:
    """Whether mode "slab" runs a pass's MASKED instance (the element
    compare) at P = ``tok_per_time``: unless P is a multiple of 64 and of
    the pass's tile (the forward's 128 keys at head_dim 64, else 64)."""
    tile = 128 if pass_ == "fwd" and head_dim == 64 else 64
    return tok_per_time % 64 != 0 or tok_per_time % tile != 0


def occupancy(mode: str, pass_: str, head_dim: int = 32,
              masked: bool = False) -> tuple:
    """(registers a thread, resident CTAs an SM) of one pass ("fwd", "dq"
    or "dkv") of a mode's kernel at ``head_dim`` (mode "slab": its
    ``masked`` instance or the unmasked one), on the current card, from the
    CUDA runtime."""
    if masked and mode != "slab":
        raise ValueError(f"mode {mode!r} has no masked instance")
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    rc = build.library().fk_flash_attention_occupancy(
        MODES[mode], PASSES[pass_] + (3 if masked else 0), head_dim,
        ctypes.byref(regs), ctypes.byref(ctas))
    build.check(rc, f"flash_attention_occupancy[{mode}, {pass_}]")
    return regs.value, ctas.value


class FlashAttention(torch.autograd.Function):
    """out = flash_attention(q, k, v, ...): K6 / K7 forward and backward
    (their twins on the CPU). Saves q, k, v, out, lse and the slab ids, as
    the JAX package's custom VJPs do; the slab ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, slab_ids, n_heads: int, mode: str,
                tok_per_time: int):
        kw = dict(n_heads=n_heads, mode=mode, tok_per_time=tok_per_time)
        out, lse = flash_attention(q, k, v, slab_ids=slab_ids, **kw)
        ctx.save_for_backward(q, k, v, slab_ids, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, slab_ids, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         slab_ids=slab_ids, **ctx.kw)
        return dq, dk, dv, None, None, None, None
