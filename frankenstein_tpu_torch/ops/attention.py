"""Scaled dot-product attention (``frankenstein_tpu/ops/attention.py``).

Shapes follow the JAX package: [B, T, H, D]. Scores and softmax are float32
whatever the input dtype; the probabilities are cast to v's dtype before the
AV product, which accumulates in float32 and rounds to q's dtype.
``mask_mode``: None (dense), "causal" (suffix-aligned), "slab"
(slab(j) <= slab(i) over time slabs of ``tok_per_time`` tokens) or
"gathered_slab" (the same over the original ``positions`` of a gathered
token subset, the MAE's kept tokens). An explicit boolean ``mask`` (True =
attend; [Tq, Tk], [B, Tq, Tk] or [B, 1, Tq, Tk], its suffix rows and
columns taken) is ANDed with any mode: the padding masks of SimpleMAE.

``dot_product_attention`` routes as the JAX package does on the TPU:
"gathered_slab", "slab" and dense attention over ``DENSE_FLASH_MIN`` tokens
or more, each with Tq == Tk, run kernels K6 / K7 (their twins on the CPU,
``ops/cuda/flash_attention.py``) where ``flash_attention.supported`` holds;
everything else (an f32 or odd-length input on the card, causal, the
Perceiver's short self-attention, cross-attention, and any call with an
explicit ``mask``, which the JAX package also sends to XLA) runs the plain
path here, "gathered_slab" with a [B, N, N] mask from ``positions``. A
query row that sees no key (a padded token) takes NEG_INF in every score
and comes out as the uniform average of v, as in the JAX package.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import torch

from frankenstein_tpu_torch.ops import masks as mask_lib
from frankenstein_tpu_torch.ops.cuda import flash_attention as flash
from frankenstein_tpu_torch.parallel import mesh as mesh_lib

NEG_INF = float(torch.finfo(torch.float32).min)
# dense attention this long or longer runs K7: below it the scores are
# small enough for the plain path (the JAX package's ``big_enough`` gate)
DENSE_FLASH_MIN = 2048


def _softmax_av(logits, v, out_dtype, rate: float = 0.0, generator=None,
                dropout_part=None):
    """float32 softmax over the last axis (dropout at ``rate``, its mask
    cut by ``dropout_part``), then probs (in v's dtype) @ v."""
    weights = dropout(torch.softmax(logits, dim=-1), rate, generator,
                      dropout_part)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(),
                       v.float())
    return out.to(out_dtype)


def dropout(x, rate: float, generator: Optional[torch.Generator],
            part: Optional[tuple] = None):
    """Inverted dropout (flax ``nn.Dropout``): keep with probability
    1 - rate, scale the kept values by 1 / (1 - rate). The mask is drawn
    from ``generator``, on x's device, for the global batch under
    ``mesh.batch_shard`` (``mesh.global_rows``); ``part`` = (dim, rank,
    size) draws it ``size`` times x's extent on ``dim`` (> 0) and keeps
    part ``rank`` (a tensor-parallel rank's heads of every head's mask);
    rate 0 returns x."""
    if rate <= 0.0:
        return x
    shape = list(x.shape[1:])
    cut = lambda mask: mask
    if part is not None:
        dim, rank, size = part
        width = x.shape[dim]
        shape[dim - 1] *= size
        cut = lambda mask: mask.narrow(dim, rank * width, width)
    keep = mesh_lib.global_rows(
        lambda n: cut(torch.rand([n] + shape, generator=generator,
                                 device=x.device)), x.shape[0]) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def _flash(q, k, v, mode: str, tok_per_time: int = 0, slab_ids=None):
    """K6 / K7 (``FlashAttention``) on [B, T, H, D] tensors, folded to
    [B, T, H*D] for the kernels and back."""
    b, t, h, d = q.shape
    fold = lambda x: x.reshape(b, t, h * d).contiguous()
    out = flash.FlashAttention.apply(fold(q), fold(k), fold(v), slab_ids, h,
                                     mode, tok_per_time)
    return out.reshape(b, t, h, d)


def _broadcast_mask(mask: torch.Tensor, tq: int, tk: int) -> torch.Tensor:
    """A boolean mask as [B or 1, 1, Tq, Tk]: its last Tq rows and Tk
    columns, as the reference slices ``attn_mask[..., -t_q:, -t_k:]``."""
    if mask.ndim == 2:
        mask = mask[None, None]
    elif mask.ndim == 3:
        mask = mask[:, None]
    return mask[..., -tq:, -tk:]


def dot_product_attention(q, k, v, *, mask: Optional[torch.Tensor] = None,
                          mask_mode: Optional[str] = None,
                          tok_per_time: int = 0,
                          positions: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Attention over [B, T, H, D] tensors. Returns [B, Tq, H, D].
    ``mask``: an explicit boolean mask (True = attend), ANDed with the
    mode's; a call with one runs the plain path. ``positions`` ([B, T]
    ints, the original token positions) is read by "gathered_slab" only."""
    tq, tk, h, d = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    if mask_mode == "gathered_slab" and (positions is None
                                         or tok_per_time <= 0):
        raise ValueError("mask_mode='gathered_slab' needs positions and "
                         "tok_per_time > 0")
    if mask_mode == "slab" and tok_per_time <= 0:
        raise ValueError("mask_mode='slab' needs tok_per_time > 0")
    if mask is None and tq == tk and flash.supported(q.device, q.dtype, tq,
                                                     h * d, h):
        if mask_mode == "gathered_slab":
            slab_ids = (positions // tok_per_time).to(torch.int32)
            return _flash(q, k, v, "positions",
                          slab_ids=slab_ids.contiguous())
        if mask_mode == "slab":
            return _flash(q, k, v, "slab", tok_per_time)
        if mask_mode is None and tq >= DENSE_FLASH_MIN:
            return _flash(q, k, v, "dense")
    scale = 1.0 / float(d) ** 0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale

    if mask_mode == "causal":
        allowed = mask_lib.causal_mask(tq, tk, q.device)
    elif mask_mode == "slab":
        allowed = mask_lib.block_causal_mask(tk, tok_per_time,
                                             q.device)[-tq:, -tk:]
    elif mask_mode == "gathered_slab":
        allowed = mask_lib.block_causal_mask_from_positions(
            positions, positions, tok_per_time)[:, None]
    elif mask_mode is None:
        allowed = None
    else:
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    if mask is not None:
        given = _broadcast_mask(mask, tq, tk)
        allowed = given if allowed is None else allowed & given
    if allowed is not None:
        logits = logits.masked_fill(~allowed, NEG_INF)
    return _softmax_av(logits, v, q.dtype)


def cached_attention(q, k_cache, v_cache, length: int, *,
                     probs_dropout_rate: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     dropout_part: Optional[tuple] = None
                     ) -> torch.Tensor:
    """Attention against a fixed-shape KV cache.

    q: [B, T, H, D]; k_cache/v_cache: [B, S, H, D]; length: the number of
    cache entries visible to query row 0 (prior context + 1 for its own
    key). Row i sees positions j < length + i. ``probs_dropout_rate``
    applies inverted dropout to the f32 probabilities, drawn from
    ``generator`` (training only), cut by ``dropout_part`` (``dropout``'s
    ``part``).
    """
    b, t, _, d = q.shape
    s = k_cache.shape[1]
    scale = 1.0 / float(d) ** 0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    kj = torch.arange(s, device=q.device)[None, :]
    qi = torch.arange(t, device=q.device)[:, None]
    logits = logits.masked_fill(~(kj < qi + length), NEG_INF)
    return _softmax_av(logits, v_cache, q.dtype, probs_dropout_rate,
                       generator, dropout_part)


def qk_int8_fallback(reason: str) -> None:
    """Signal that ``qk_int8`` was asked for but this call computes exact
    scores (the JAX package's ``qk_int8_fallback``): a speed switch must not
    silently do nothing, so it warns, and raises ``ValueError`` under
    ``FK_QK_INT8_STRICT=1``."""
    msg = f"qk_int8 requested but computing exact scores: {reason}"
    if os.environ.get("FK_QK_INT8_STRICT", "0") == "1":
        raise ValueError(msg)
    warnings.warn(msg, stacklevel=3)


def slab_attention_rope_fused(q, k, v, *, n_heads: int, tok_per_time: int,
                              rope_cache, qk_int8: bool = False
                              ) -> torch.Tensor:
    """Slab-causal attention over UNROTATED folded [B, T, E] q/k/v with RoPE
    (suffix-aligned) applied inside kernel K1, or with ``qk_int8`` inside
    K10 (int8 QK scores) where its gate holds, differentiable through kernel
    K4 (``ops/cuda/slab_attention.py:SlabRopeAttention``). A ``qk_int8``
    that K10's gate refuses (T % 1024 != 0) signals ``qk_int8_fallback``
    and computes exact scores. Returns [B, T, E]."""
    from frankenstein_tpu_torch.ops import rope
    from frankenstein_tpu_torch.ops.cuda import slab_attention
    b, t, e = q.shape
    if qk_int8 and not slab_attention.supported(q.device, q.dtype, t, e,
                                                n_heads, True):
        qk_int8_fallback(f"K10's gate rejected b={b} t={t} e={e} "
                         f"h={n_heads} dtype={q.dtype} device={q.device}")
        qk_int8 = False
    cos, sin = rope.folded_tables(rope_cache[-t:], 1)
    return slab_attention.SlabRopeAttention.apply(q, k, v, cos, sin, n_heads,
                                                  tok_per_time, qk_int8)
