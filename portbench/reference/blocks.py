"""Plain float32 building blocks of the reference models.

Written from the models' equations (the BrainFormer encoder, its Perceiver
resampler, GPT-2), with no kernel, cache or batching of the program, and
importing nothing of it. Every matrix product takes its operands through a
``Numerics`` object: ``FP32`` leaves them as they are, and the controls
(``reference/lowp.py``) round them to a lower precision.

Departures from the published description, all shared with the program
under test: the slab-causal mask (a token sees every token of its own and
earlier time slabs), RoPE on adjacent pairs (2i, 2i+1), and LayerNorm with
eps 1e-5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


class Numerics:
    """Full float32: every operand as it is. Subclasses round ``act`` (an
    activation entering a product), ``weight`` (a named weight entering a
    product) and ``kv`` (cached keys or values) to a lower precision."""

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        return w

    def kv(self, x: torch.Tensor) -> torch.Tensor:
        return x


FP32 = Numerics()
SCORE_BYTES = 1 << 31     # the most one chunk's f32 scores may take


def linear(x, params: dict, name: str, num: Numerics = FP32, bias=True):
    """x @ W^T (+ b) for the ``nn.Linear`` weights ``<name>.weight`` [out,
    in] and ``<name>.bias``."""
    w = num.weight(name + ".weight", params[name + ".weight"])
    out = num.act(x) @ w.t()
    if bias and (name + ".bias") in params:
        out = out + params[name + ".bias"]
    return out


def layer_norm(x, params: dict, name: str, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (x - mean) / torch.sqrt(var + eps) * params[name + ".weight"]
    if (name + ".bias") in params:
        out = out + params[name + ".bias"]
    return out


def rope_table(head_dim: int, positions: torch.Tensor,
               theta: float = 10000.0):
    """(cos, sin) [..., D/2] at integer ``positions``, the angles taken in
    float32 as the model defines its table."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                          device=positions.device,
                                          dtype=torch.float32) / head_dim))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rotate(x, cos, sin):
    """Rotate adjacent pairs (2i, 2i+1) of x [B, T, H, D] by angles whose
    (cos, sin) are [T, D/2] or [B, T, D/2]."""
    if cos.ndim == 2:
        cos, sin = cos[None, :, None], sin[None, :, None]
    else:
        cos, sin = cos[:, :, None], sin[:, :, None]
    xr = x.reshape(*x.shape[:-1], -1, 2)
    a, b = xr[..., 0], xr[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       dim=-1).reshape(x.shape)


def attend(q, k, v, allowed=None, num: Numerics = FP32):
    """softmax(q k^T / sqrt(D)) v over [B, T, H, D] q and [B, S, H, D] k,
    v; ``allowed`` a bool mask [Tq, S] or [B, Tq, S] (True = attend)."""
    q = q / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", num.act(q), num.act(k))
    if allowed is not None:
        mask = allowed[None, None] if allowed.ndim == 2 else allowed[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", num.act(probs), num.act(v))


def attend_in_chunks(q, k, v, allowed_fn, num: Numerics = FP32,
                     chunk: int = 1024):
    """``attend`` over query rows in chunks of at most ``chunk`` (fewer
    where the batch is wide: a chunk's scores stay under SCORE_BYTES), each
    recomputed in the backward (so a [T, T] score matrix never lives whole):
    ``allowed_fn(lo, hi)`` gives the mask of query rows [lo, hi), or None.
    Keys past the last one that the chunk may see are not multiplied."""
    outs = []
    b, t, h, _ = q.shape
    chunk = max(64, min(chunk, SCORE_BYTES // (4 * b * h * k.shape[1])))
    for lo in range(0, t, chunk):
        hi = min(t, lo + chunk)
        allowed = allowed_fn(lo, hi)
        s = k.shape[1]
        if allowed is not None:
            seen = allowed.reshape(-1, allowed.shape[-1]).any(dim=0)
            s = int(seen.nonzero().max()) + 1 if bool(seen.any()) else 1
            allowed = allowed[..., :s]
        fn = lambda qq, kk, vv, al=allowed: attend(qq, kk, vv, al, num)
        args = (q[:, lo:hi], k[:, :s], v[:, :s])
        if torch.is_grad_enabled():
            outs.append(checkpoint(fn, *args, use_reentrant=False))
        else:
            outs.append(fn(*args))
    return torch.cat(outs, dim=1)


def swiglu(x, params: dict, name: str, num: Numerics = FP32):
    """w2(silu(w1 x) * w3 x), no biases."""
    a = linear(x, params, name + ".w1", num, bias=False)
    g = linear(x, params, name + ".w3", num, bias=False)
    return linear(F.silu(a) * g, params, name + ".w2", num, bias=False)


def self_attention(x, params: dict, name: str, n_heads: int, rope=None,
                   allowed_fn=None, num: Numerics = FP32, chunk: int = 1024):
    """Multi-head self-attention (``qw``, ``kw``, ``vw``, ``project``, no
    biases) with RoPE (``rope`` = (cos, sin)) and a mask by query rows."""
    b, t, _ = x.shape
    heads = lambda y: y.reshape(b, t, n_heads, -1)
    q = heads(linear(x, params, name + ".qw", num, bias=False))
    k = heads(linear(x, params, name + ".kw", num, bias=False))
    v = heads(linear(x, params, name + ".vw", num, bias=False))
    if rope is not None:
        q, k = rotate(q, *rope), rotate(k, *rope)
    if allowed_fn is None:
        out = attend(q, k, v, None, num)
    else:
        out = attend_in_chunks(q, k, v, allowed_fn, num, chunk)
    return linear(out.reshape(b, t, -1), params, name + ".project", num,
                  bias=False)


def block(x, params: dict, name: str, n_heads: int, rope=None,
          allowed_fn=None, num: Numerics = FP32, chunk: int = 1024):
    """Pre-norm residual block: self-attention, then a SwiGLU MLP."""
    x = x + self_attention(layer_norm(x, params, name + ".ln_1"), params,
                           name + ".attn", n_heads, rope, allowed_fn, num,
                           chunk)
    return x + swiglu(layer_norm(x, params, name + ".ln_2"), params,
                      name + ".mlp", num)


def slab_allowed(q_pos, k_pos, tok_per_time: int):
    """slab(k) <= slab(q), slab(i) = i // tok_per_time, over positions
    [..., Tq] and [..., Tk] -> [..., Tq, Tk]."""
    return (k_pos // tok_per_time)[..., None, :] <= \
        (q_pos // tok_per_time)[..., :, None]


def to_patches(x, patch_size: int):
    """[B, T, C] -> [B, (T / p) * C, p]: token (slab, electrode) holds that
    electrode's ``p`` samples of the slab."""
    b, t, c = x.shape
    x = x.reshape(b, t // patch_size, patch_size, c).permute(0, 1, 3, 2)
    return x.reshape(b, (t // patch_size) * c, patch_size)
