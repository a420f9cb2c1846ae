"""Attention-mask builders (``frankenstein_tpu/ops/masks.py``).

The reference's slab-causal mask collapses to the closed form
``allowed(i, j) <=> slab(j) <= slab(i)`` with ``slab(k) = k // tok_per_time``.
Dense masks are built only when asked for; the attention paths compute the
structure from positions.
"""

from __future__ import annotations

import torch


def slab_ids(n: int, tok_per_time: int, device=None) -> torch.Tensor:
    """Slab index of each of n tokens."""
    return torch.arange(n, device=device) // tok_per_time


def block_causal_mask(block_size: int, tok_per_time: int,
                      device=None) -> torch.Tensor:
    """Dense [T, T] bool mask, True = attend."""
    s = slab_ids(block_size, tok_per_time, device)
    return s[None, :] <= s[:, None]


def block_causal_mask_from_positions(q_pos: torch.Tensor,
                                     k_pos: torch.Tensor,
                                     tok_per_time: int) -> torch.Tensor:
    """Mask of a gathered token subset (the MAE's kept tokens):
    [..., Tq] x [..., Tk] positions -> [..., Tq, Tk] bool, True where
    slab(k_pos) <= slab(q_pos)."""
    sq = q_pos // tok_per_time
    sk = k_pos // tok_per_time
    return sk[..., None, :] <= sq[..., :, None]


def causal_mask(t_q: int, t_k: int, device=None) -> torch.Tensor:
    """Causal mask aligned to the sequence END: query i (of t_q) sits at
    absolute position t_k - t_q + i."""
    qi = torch.arange(t_q, device=device)[:, None]
    kj = torch.arange(t_k, device=device)[None, :]
    return kj <= qi + (t_k - t_q)


def padding_mask(x: torch.Tensor, pad_value: float = 0.0) -> torch.Tensor:
    """[B, T, C] -> [B, T] bool, True where the timestep is real: not all
    of its channels equal ``pad_value``."""
    return ~torch.all(x == pad_value, dim=-1)


def self_attention_padding_mask(valid: torch.Tensor) -> torch.Tensor:
    """[B, T] valid flags -> [B, T, T] pairwise mask, valid_i & valid_j."""
    return valid[:, :, None] & valid[:, None, :]
