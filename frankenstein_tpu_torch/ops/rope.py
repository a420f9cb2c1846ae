"""Rotary position embeddings (``frankenstein_tpu/ops/rope.py``).

Real cos/sin tables; adjacent elements (2i, 2i+1) form the rotated pairs.
``align`` picks the suffix (decode semantics) or the prefix of a longer table.
Rotation runs in float32 (float64 for float64 input) and rounds back to the
input dtype.
"""

from __future__ import annotations

import torch


def build_rope_cache(dim: int, seq_len: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Return a [seq_len, dim//2, 2] float32 table of (cos, sin)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)


def rope_for_positions(cache: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """Gather per-token rope entries: positions [..., T] ->
    [..., T, dim//2, 2]."""
    return cache[positions]


def _slice(table: torch.Tensor, t: int, align: str) -> torch.Tensor:
    return table[-t:] if align == "suffix" else table[:t]


def apply_rope(x: torch.Tensor, rope: torch.Tensor,
               align: str = "suffix") -> torch.Tensor:
    """Rotate [B, T, H, D] activations with a shared [S, D//2, 2] table."""
    b, t, h, d = x.shape
    if rope.ndim != 3:
        raise ValueError(f"rope must be a shared [S, D//2, 2] table, got "
                         f"rank {rope.ndim}")
    rope = _slice(rope, t, align)[None, :, None]          # [1, T, 1, d/2, 2]
    xf = x.float().reshape(b, t, h, d // 2, 2)
    x_re, x_im = xf[..., 0], xf[..., 1]
    cos, sin = rope[..., 0].float(), rope[..., 1].float()
    out_re = x_re * cos - x_im * sin
    out_im = x_re * sin + x_im * cos
    return torch.stack([out_re, out_im], dim=-1).reshape(b, t, h, d).to(x.dtype)


def folded_tables(cache: torch.Tensor, n_heads: int):
    """[S, d//2, 2] cache -> per-lane (cos_e, sin_e) tables [S, n_heads*d]."""
    cos = torch.repeat_interleave(cache[..., 0], 2, dim=-1)
    sin = torch.repeat_interleave(cache[..., 1], 2, dim=-1)
    return cos.float().repeat(1, n_heads), sin.float().repeat(1, n_heads)


def apply_rope_folded(x: torch.Tensor, cos_e: torch.Tensor,
                      sin_e: torch.Tensor, align: str = "suffix") -> torch.Tensor:
    """Rotate [..., T, E] activations with per-lane [S, E] tables:
    out[2i] = x[2i] cos_i - x[2i+1] sin_i, out[2i+1] = x[2i] sin_i + x[2i+1] cos_i.
    """
    t = x.shape[-2]
    acc = torch.promote_types(x.dtype, torch.float32)   # f64 stays f64
    cos_e = _slice(cos_e, t, align).to(acc)
    sin_e = _slice(sin_e, t, align).to(acc)
    xf = x.to(acc)
    pairs = xf.unflatten(-1, (-1, 2))
    swapped = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return (xf * cos_e + swapped * sin_e).to(x.dtype)
