"""SimpleMAE: a masked autoencoder over whole-timestep tokens
(``frankenstein_tpu/models/simple_mae.py``: ``SimpleEncoder``,
``SimpleMAE``).

A token is one timestep of the window, all its channels (x [B, T, C] with
C == ``patch_size``). There is no causality: attention is dense over the
tokens that are not padding, a padded timestep being one whose channels
are all zero. Every block is an RMSNorm ``Block`` (kernel K9's RMSNorm
kind where its gate holds) whose rope table is prefix-aligned; the padding
masks send each attention to the plain path, as the JAX package sends them
to XLA. The decoder's position embedding is added in natural token order,
as in the JAX package. Parameter names are the reference's, as
``models/import_reference.py:export_simple_mae`` writes them.
``dtype`` is the compute dtype (``models/layers.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from frankenstein_tpu_torch.config import SimpleEncoderConfig, SimpleMAEConfig
from frankenstein_tpu_torch.models.brainformer import (_put, _take,
                                                       masking_indices)
from frankenstein_tpu_torch.models.layers import (Block, LayerNorm, linear,
                                                  run_block)
from frankenstein_tpu_torch.ops import masks as mask_lib
from frankenstein_tpu_torch.ops import rope as rope_ops


class SimpleEncoder(nn.Module):
    """Linear embed + RMSNorm blocks + final LayerNorm, under
    ``transformer`` as in the reference's state dict."""

    def __init__(self, cfg: SimpleEncoderConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.transformer = nn.ModuleDict({
            "emb": nn.Linear(cfg.patch_size, cfg.dim, device=device),
            "h": nn.ModuleList(
                Block(cfg.dim, cfg.n_heads, cfg.head_dim, cfg.hidden_dim,
                      device, dtype, norm="rmsnorm", rope_align="prefix")
                for _ in range(cfg.n_layers)),
            "ln_f": LayerNorm(cfg.dim, device=device),
        })

    def forward(self, x: torch.Tensor, mask=None, rope=None,
                remat: bool = False) -> torch.Tensor:
        """x: [B, N, patch_size] tokens -> [B, N, dim]. ``mask``: [B, N, N]
        bool, True = attend; ``rope``: a shared [S, D/2, 2] table (the
        first N rows are used) or a per-sample [B, N, D/2, 2] one, the
        positions' rows of the block_size table by default."""
        c = self.cfg
        if rope is None:
            rope = rope_ops.build_rope_cache(c.head_dim, c.block_size,
                                             c.rope_theta, device=x.device)
        tok = linear(x, self.transformer["emb"], self.compute_dtype)
        for block in self.transformer["h"]:
            tok = run_block(block, tok, remat=remat, mask=mask, rope=rope)
        return self.transformer["ln_f"](tok)


class SimpleMAE(nn.Module):
    """The encoder over the kept timesteps, then a decoder over all of
    them: ``encoder``, ``decoder.emb`` (encoder width -> decoder width),
    ``decoder.h.{i}``, ``mask_token``, ``decoder_pos_emb``, ``to_signals``.
    ``remat``, read at each forward, recomputes every block's activations
    in the backward."""

    needs_labels = False    # the trainer passes it no targets

    def __init__(self, enc_cfg: SimpleEncoderConfig,
                 dec_cfg: SimpleMAEConfig, device=None, dtype=None):
        super().__init__()
        self.enc_cfg, self.dec_cfg = enc_cfg, dec_cfg
        self.compute_dtype = dtype
        self.remat = False
        self.encoder = SimpleEncoder(enc_cfg, device, dtype)
        self.decoder = nn.ModuleDict({
            "emb": nn.Linear(enc_cfg.dim, dec_cfg.dim, device=device),
            "h": nn.ModuleList(
                Block(dec_cfg.dim, dec_cfg.n_heads, dec_cfg.head_dim,
                      dec_cfg.hidden_dim, device, dtype, norm="rmsnorm",
                      rope_align="prefix")
                for _ in range(dec_cfg.n_layers))})
        self.mask_token = nn.Parameter(torch.zeros(dec_cfg.dim,
                                                   device=device))
        self.decoder_pos_emb = nn.Embedding(enc_cfg.block_size, dec_cfg.dim,
                                            device=device)
        self.to_signals = nn.Linear(dec_cfg.dim, enc_cfg.patch_size,
                                    device=device)

    def forward(self, x, targets=None, train: bool = False,
                generator=None, date_info=None, indices=None,
                masking_ratio=None, return_preds: bool = False):
        """x: [B, T, C] signal, T <= block_size, C == patch_size;
        ``targets``, ``train`` and ``date_info`` are ignored (the trainer's
        uniform contract; no dropout, no session embedding). The mask is
        drawn from ``generator`` (on the model's device), or given as
        ``indices`` = (masked, kept), sorted [B, M] and [B, T - M].

        Returns (loss, None): the mean squared error of the masked
        timesteps that are not padding (mean over channels, then over
        those timesteps); or with ``return_preds`` (loss, recon, binary),
        the window with its masked timesteps predicted and 1 where they
        were masked, both [B, T, C]."""
        ec, dc = self.enc_cfg, self.dec_cfg
        ratio = dc.masking_ratio if masking_ratio is None else masking_ratio
        b, t, _ = x.shape
        if indices is None:
            indices = masking_indices(generator, b, t, ratio,
                                      device=x.device)
        masked, kept = indices

        valid = mask_lib.padding_mask(x)                        # [B, T]
        pair = mask_lib.self_attention_padding_mask(valid)      # [B, T, T]
        kept_pair = mask_lib.self_attention_padding_mask(
            torch.gather(valid, 1, kept))
        rope_cache = rope_ops.build_rope_cache(ec.head_dim, ec.block_size,
                                               ec.rope_theta,
                                               device=x.device)
        kept_rope = rope_ops.rope_for_positions(rope_cache, kept)

        # the encoder sees the kept timesteps, at their own rope rows
        tokens = self.encoder(_take(x, kept), mask=kept_pair,
                              rope=kept_rope, remat=self.remat)

        # the decoder sees every timestep: the embedded kept tokens at
        # their positions and the mask token elsewhere, in the tokens'
        # dtype, plus the position embedding
        dec = self.mask_token.to(tokens.dtype).expand(b, t, -1)
        emb = linear(tokens, self.decoder["emb"], self.compute_dtype)
        dec = _put(dec, kept, emb.to(dec.dtype))
        dec = dec + self.decoder_pos_emb.weight[None, :t].to(dec.dtype)
        for block in self.decoder["h"]:
            dec = run_block(block, dec, remat=self.remat, mask=pair)
        pred = linear(dec, self.to_signals, self.compute_dtype)

        pred_masked = _take(pred, masked)
        mask_valid = torch.gather(valid, 1, masked)             # [B, M]
        err = torch.mean(torch.square(pred_masked.float()
                                      - _take(x, masked).float()), dim=-1)
        denom = torch.clamp(mask_valid.sum(), min=1)
        loss = torch.sum(err * mask_valid) / denom
        if not return_preds:
            return loss, None
        binary = _put(torch.zeros_like(x), masked, 1.0)
        recon = _put(x, masked, pred_masked.to(x.dtype))
        return loss, recon, binary
