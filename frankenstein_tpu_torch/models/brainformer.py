"""BrainFormer encoder and Perceiver resampler
(``frankenstein_tpu/models/brainformer.py``: ``to_patches``, ``Encoder``,
``BrainEncoder``).

The 6144-token slab-causal encoder attention runs kernel K1 on the card,
and its backward kernel K4. ``dtype`` is the compute dtype
(``models/layers.py``). The MAE pretrainer and ``forward_subset`` are not
ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from frankenstein_tpu_torch.config import MAEConfig, PerceiverConfig
from frankenstein_tpu_torch.models.layers import (Block, CrossBlock,
                                                  LayerNorm, linear,
                                                  run_block)
from frankenstein_tpu_torch.ops import rope as rope_ops


def to_patches(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, T, C] -> [B, (T/p * C), p], token order (time-slab, electrode)."""
    b, t, c = x.shape
    x = x.reshape(b, t // patch_size, patch_size, c).permute(0, 1, 3, 2)
    return x.reshape(b, (t // patch_size) * c, patch_size)


class Encoder(nn.Module):
    """Patch + embed + space embedding + slab-causal transformer. Submodules
    sit under ``transformer`` as in the reference's state dict."""

    def __init__(self, cfg: MAEConfig, device=None, dtype=None):
        super().__init__()
        if cfg.qk_int8:
            raise NotImplementedError(
                "qk_int8: int8 QK scores are kernel K10, not ported yet "
                "(ROADMAP.md, kernel queue)")
        if cfg.n_sessions:
            raise NotImplementedError(
                "n_sessions > 0: the session embedding is not ported yet")
        self.cfg = cfg
        self.compute_dtype = dtype
        self.transformer = nn.ModuleDict({
            "emb": nn.Linear(cfg.patch_size, cfg.dim, device=device),
            "h": nn.ModuleList(
                Block(cfg.dim, cfg.n_heads, cfg.head_dim, cfg.hidden_dim,
                      device, dtype) for _ in range(cfg.n_layers)),
            "ln_f": LayerNorm(cfg.dim, device=device),
        })
        self.space_embedding = nn.Parameter(
            torch.zeros(1, cfg.n_electrodes, cfg.dim, device=device))

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """x: [B, T, C] signal -> [B, n_tokens, dim] context. ``remat``
        recomputes each block's activations in the backward."""
        c = self.cfg
        tr = self.transformer
        tok = linear(to_patches(x, c.patch_size), tr["emb"],
                     self.compute_dtype)
        space = self.space_embedding.repeat(1, c.n_patches_per_channel, 1)
        tok = tok + space.to(tok.dtype)[:, -tok.shape[1]:]
        rope = rope_ops.build_rope_cache(c.head_dim, c.block_size,
                                         c.rope_theta, device=x.device)
        for block in tr["h"]:
            tok = run_block(block, tok, remat=remat, mask_mode="slab",
                            tok_per_time=c.n_electrodes, rope=rope)
        return tr["ln_f"](tok)


class Perceiver(nn.Module):
    """The resampler's blocks, final norm and output head (``perceiver.*``
    in the reference's state dict)."""

    def __init__(self, cfg: PerceiverConfig, device=None, dtype=None):
        super().__init__()
        self.h = nn.ModuleList(
            CrossBlock(cfg.dim, cfg.n_heads, cfg.head_dim, cfg.hidden_dim,
                       device, dtype) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.dim, device=device)
        self.to_words = nn.Linear(cfg.dim, cfg.output_dim, device=device)


class BrainEncoder(nn.Module):
    """Encoder + Perceiver resampler -> n_output_tokens vectors of
    output_dim."""

    def __init__(self, cfg: PerceiverConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.encoder = Encoder(cfg.encoder, device, dtype)
        self.learnable_queries = nn.Parameter(
            torch.zeros(1, cfg.n_output_tokens, cfg.dim, device=device))
        self.perceiver = Perceiver(cfg, device, dtype)

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """x: [B, T, C] -> [B, n_output_tokens, output_dim]."""
        c = self.cfg
        cdt = self.compute_dtype or self.learnable_queries.dtype
        context = self.encoder(x, remat)
        q = self.learnable_queries.to(cdt).expand(x.shape[0], -1, -1)
        rope = rope_ops.build_rope_cache(c.head_dim, c.n_output_tokens,
                                         c.rope_theta, device=x.device)
        for block in self.perceiver.h:
            q = run_block(block, q, context, remat=remat, sa_rope=rope)
        return linear(self.perceiver.ln_f(q), self.perceiver.to_words,
                      self.compute_dtype)
