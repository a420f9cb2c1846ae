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


def causal_mask(t_q: int, t_k: int, device=None) -> torch.Tensor:
    """Causal mask aligned to the sequence END: query i (of t_q) sits at
    absolute position t_k - t_q + i."""
    qi = torch.arange(t_q, device=device)[:, None]
    kj = torch.arange(t_k, device=device)[None, :]
    return kj <= qi + (t_k - t_q)
