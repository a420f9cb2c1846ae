"""Shared transformer blocks (``frankenstein_tpu/models/layers.py``).

Module and parameter names are the reference's torch names, so the JAX
package's exporter (``models/import_reference.py:export_franky``) is the
weight bridge.

Every module takes ``dtype``, the compute dtype (flax's ``dtype``), apart
from the parameters' dtype (flax's ``param_dtype``): ``linear`` casts its
input, weight and bias to it. None computes in the parameters' dtype, so a
model cast whole to bf16 for serving computes in bf16. Training keeps f32
parameters and computes in bf16, as the JAX package does. Norms, softmax and
score accumulation stay f32 either way, and LayerNorm keeps its rounding
point (``ops/norms.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from frankenstein_tpu_torch.ops import attention as attn_ops
from frankenstein_tpu_torch.ops import norms
from frankenstein_tpu_torch.ops import rope as rope_ops
from frankenstein_tpu_torch.ops.cuda import fused_mlp, slab_attention
from frankenstein_tpu_torch.parallel import mesh as mesh_lib


def linear(x: torch.Tensor, layer: nn.Linear,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``nn.Dense(dtype=dtype)``: input, weight and bias cast to the compute
    dtype (the weight's own dtype when None). A layer that
    ``parallel/sharding.py:shard_params`` split (``layer.tp``) computes its
    part: a column split this rank's output features (its input's gradient
    summed over the group), a row split its input features' share, summed
    over the group before the bias."""
    cdt = dtype or layer.weight.dtype
    bias = None if layer.bias is None else layer.bias.to(cdt)
    tp = getattr(layer, "tp", None)
    if tp is None:
        return F.linear(x.to(cdt), layer.weight.to(cdt), bias)
    kind, group = tp
    if kind == "col":
        return F.linear(mesh_lib.copy_to_group(x.to(cdt), group),
                        layer.weight.to(cdt), bias)
    if kind != "row":
        raise ValueError(f"linear() takes column or row splits, not {kind}")
    out = mesh_lib.reduce_from_group(
        F.linear(x.to(cdt), layer.weight.to(cdt)), group)
    return out if bias is None else out + bias


def embedding(idx: torch.Tensor, table: nn.Embedding) -> torch.Tensor:
    """``table(idx)``; a vocab-split table (``table.tp``) looks up the ids
    in its rows and sums the parts over the group."""
    tp = getattr(table, "tp", None)
    if tp is None:
        return table(idx)
    group = tp[1]
    rows = table.weight.shape[0]
    lo = mesh_lib.group_rank(group) * rows
    mine = (idx >= lo) & (idx < lo + rows)
    part = F.embedding(torch.where(mine, idx - lo, torch.zeros_like(idx)),
                       table.weight) * mine[..., None]
    return mesh_lib.reduce_from_group(part, group)


def refuse_tp(what: str, modules) -> None:
    """Raise ``NotImplementedError`` when any of ``modules`` carries a
    tensor-parallel split (``tp``): serving (prefill, the decode steps, the
    stacked decode weights) takes whole layers, as the JAX package never
    wired tensor-parallel serving."""
    if any(getattr(m, "tp", None) is not None for m in modules):
        raise NotImplementedError(
            f"{what} on a tensor-parallel split model: parallel/sharding.py:"
            "shard_params split its layers and serving takes whole ones "
            "(the JAX package never wired tensor-parallel serving); serve "
            "the full weights (sharding.full_state)")


def run_block(block, *args, remat: bool = False, **kwargs):
    """``block(*args, **kwargs)``; with ``remat`` (and autograd on) its
    activations are recomputed in the backward instead of kept
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False, **kwargs)
    return block(*args, **kwargs)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, bias: bool = True,
                 device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = (nn.Parameter(torch.zeros(dim, device=device))
                     if bias else None)

    def forward(self, x):
        return norms.layer_norm(x, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        return norms.rms_norm(x, self.weight, self.eps)


def _linear(i: int, o: int, bias: bool, device) -> nn.Linear:
    return nn.Linear(i, o, bias=bias, device=device)


class SwiGLU(nn.Module):
    """w2(silu(w1 x) * w3 x), no bias (``fused_mlp.swiglu_fn``)."""

    def __init__(self, dim: int, hidden_dim: int, device=None, dtype=None):
        super().__init__()
        self.compute_dtype = dtype
        self.w1 = _linear(dim, hidden_dim, False, device)
        self.w2 = _linear(hidden_dim, dim, False, device)
        self.w3 = _linear(dim, hidden_dim, False, device)

    def forward(self, x):
        return fused_mlp.swiglu_fn(x, self.w1.weight, self.w3.weight,
                                   self.w2.weight, self.compute_dtype)


class SelfAttention(nn.Module):
    """MHA with RoPE. The slab-causal mode with a shared rope table, no
    explicit ``mask`` and a suffix-aligned table (or one of exactly T rows)
    runs kernel K1 (``ops.attention.slab_attention_rope_fused``) where
    ``slab_attention.supported`` holds; otherwise, and in the other modes,
    ``apply_rope`` (a shared or a per-sample table, sliced by
    ``rope_align``: "suffix" or "prefix") + ``dot_product_attention``,
    which routes the MAE's "gathered_slab" encoder (with ``positions``) to
    K6 and its long dense decoder to K7 where their kernels take the input,
    and a call with a ``mask`` (SimpleMAE's padding) to the plain path.

    ``ring`` (a process group) is sequence parallelism: x holds this rank's
    T/n tokens, ``rope`` their n-th of the table (global positions), and
    the attention goes round the ring (``parallel/ring_attention.py``,
    plain torch, the JAX package's ``impl="ring"``) with the mode's mask
    from global positions; it takes no explicit ``mask`` or ``positions``.

    ``qk_int8`` asks for int8 QK scores (kernel K10, serving-grade accuracy;
    gradients approximately straight-through), as the JAX ``SelfAttention``
    does: only the K1 route honours it, and any other route calls
    ``ops.attention.qk_int8_fallback`` and computes exact scores."""

    def __init__(self, dim: int, n_heads: int, head_dim: int, device=None,
                 dtype=None, rope_align: str = "suffix"):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, head_dim
        self.compute_dtype = dtype
        self.rope_align = rope_align
        inner = n_heads * head_dim
        self.qw = _linear(dim, inner, False, device)
        self.kw = _linear(dim, inner, False, device)
        self.vw = _linear(dim, inner, False, device)
        self.project = _linear(inner, dim, False, device)

    def forward(self, x, *, mask=None, mask_mode=None, tok_per_time: int = 0,
                rope=None, positions=None, qk_int8: bool = False, ring=None):
        b, t, _ = x.shape
        cdt = self.compute_dtype
        qf, kf, vf = (linear(x, self.qw, cdt), linear(x, self.kw, cdt),
                      linear(x, self.vw, cdt))
        if (ring is None and mask_mode == "slab" and mask is None
                and rope is not None
                and rope.ndim == 3
                and (self.rope_align == "suffix" or rope.shape[0] == t)
                and slab_attention.supported(x.device, qf.dtype, t,
                                             qf.shape[-1], self.n_heads)):
            out = attn_ops.slab_attention_rope_fused(
                qf, kf, vf, n_heads=self.n_heads, tok_per_time=tok_per_time,
                rope_cache=rope, qk_int8=qk_int8)
            return linear(out, self.project, cdt)
        if qk_int8:
            attn_ops.qk_int8_fallback(
                f"SelfAttention's route is not K1's (mask_mode={mask_mode!r},"
                f" b={b}, t={t}, dtype={qf.dtype}, device={x.device})")
        shape = (b, t, self.n_heads, self.head_dim)
        q, k, v = qf.reshape(shape), kf.reshape(shape), vf.reshape(shape)
        if rope is not None:
            q = rope_ops.apply_rope(q, rope, self.rope_align)
            k = rope_ops.apply_rope(k, rope, self.rope_align)
        if ring is not None:
            from frankenstein_tpu_torch.parallel import ring_attention
            if mask is not None or positions is not None:
                raise NotImplementedError(
                    "ring attention takes mask_mode-style masks only")
            out = ring_attention.ring_attention(
                q, k, v, ring, causal=mask_mode == "causal",
                slab=tok_per_time if mask_mode == "slab" else None)
            return linear(out.reshape(b, t, -1), self.project, cdt)
        out = attn_ops.dot_product_attention(q, k, v, mask=mask,
                                             mask_mode=mask_mode,
                                             tok_per_time=tok_per_time,
                                             positions=positions)
        return linear(out.reshape(b, t, -1), self.project, cdt)


class CrossAttention(nn.Module):
    """Queries read from a (longer) context."""

    def __init__(self, dim: int, n_heads: int, head_dim: int, device=None,
                 dtype=None):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, head_dim
        self.compute_dtype = dtype
        inner = n_heads * head_dim
        self.qw = _linear(dim, inner, False, device)
        self.kw = _linear(dim, inner, False, device)
        self.vw = _linear(dim, inner, False, device)
        self.project = _linear(inner, dim, False, device)

    def forward(self, x, context):
        b, t, _ = x.shape
        tk = context.shape[1]
        cdt = self.compute_dtype
        heads = lambda y, n: y.reshape(b, n, self.n_heads, self.head_dim)
        q = heads(linear(x, self.qw, cdt), t)
        k = heads(linear(context, self.kw, cdt), tk)
        v = heads(linear(context, self.vw, cdt), tk)
        out = attn_ops.dot_product_attention(q, k, v)
        return linear(out.reshape(b, t, -1), self.project, cdt)


def make_norm(kind: str, dim: int, device=None) -> nn.Module:
    """``Block``'s norm: "layernorm" or "rmsnorm"."""
    if kind == "rmsnorm":
        return RMSNorm(dim, device=device)
    if kind == "layernorm":
        return LayerNorm(dim, device=device)
    raise ValueError(f"unknown norm {kind!r}: 'layernorm' or 'rmsnorm'")


class Block(nn.Module):
    """Pre-norm residual block, LayerNorm or RMSNorm (``norm``), its
    attention's rope table sliced by ``rope_align``. Its MLP sublayer runs
    kernel K9 (``ops/cuda/fused_mlp.py:FusedNormSwiGLU``) when
    ``fused_mlp.ENABLED`` and ``fused_mlp.supported`` hold (x in the
    compute dtype, a width the kernel takes), else the module chain."""

    def __init__(self, dim: int, n_heads: int, head_dim: int,
                 hidden_dim: int, device=None, dtype=None,
                 norm: str = "layernorm", rope_align: str = "suffix"):
        super().__init__()
        self.norm = norm
        self.ln_1 = make_norm(norm, dim, device)
        self.attn = SelfAttention(dim, n_heads, head_dim, device, dtype,
                                  rope_align)
        self.ln_2 = make_norm(norm, dim, device)
        self.mlp = SwiGLU(dim, hidden_dim, device, dtype)

    def forward(self, x, *, mask=None, mask_mode=None, tok_per_time: int = 0,
                rope=None, positions=None, qk_int8: bool = False, ring=None):
        x = x + self.attn(self.ln_1(x), mask=mask, mask_mode=mask_mode,
                          tok_per_time=tok_per_time, rope=rope,
                          positions=positions, qk_int8=qk_int8, ring=ring)
        mlp = self.mlp
        cdt = mlp.compute_dtype or mlp.w1.weight.dtype
        if fused_mlp.ENABLED and fused_mlp.supported(
                x.device, x.dtype, x.shape[-1], mlp.w1.out_features, cdt):
            return fused_mlp.FusedNormSwiGLU.apply(
                x, self.ln_2.weight, getattr(self.ln_2, "bias", None),
                mlp.w1.weight, mlp.w3.weight, mlp.w2.weight, self.norm)
        return x + mlp(self.ln_2(x))


class CrossBlock(nn.Module):
    """cross-attn + MLP (the module chain, as in the JAX package), then a
    self-attn Block."""

    def __init__(self, dim: int, n_heads: int, head_dim: int,
                 hidden_dim: int, device=None, dtype=None):
        super().__init__()
        self.ln_1 = LayerNorm(dim, device=device)
        self.cross_attn = CrossAttention(dim, n_heads, head_dim, device, dtype)
        self.ln_2 = LayerNorm(dim, device=device)
        self.mlp = SwiGLU(dim, hidden_dim, device, dtype)
        self.sa_block = Block(dim, n_heads, head_dim, hidden_dim, device,
                              dtype)

    def forward(self, x, context, *, sa_rope=None):
        x = x + self.cross_attn(self.ln_1(x), context)
        x = x + self.mlp(self.ln_2(x))
        return self.sa_block(x, rope=sa_rope)
