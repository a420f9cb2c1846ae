"""The VQ-VAE tokenizer ("SoundStream") for brain signals
(``frankenstein_tpu/models/vq_brain.py``): a causal-conv encoder (4x
temporal downsample at the default strides), the EMA vector quantizer
(``ops/vq.py``), a causal transposed-conv decoder, a pad-masked L1
reconstruction loss plus the commitment loss, and the codebook's
perplexity.

Submodules sit at the reference's ``nn.Sequential`` positions, the ELUs
between them, so the state dict is the reference's and the JAX package's
``models/import_reference.py:export_soundstream`` writes it (the weight
bridge is ``load_strict``):

    encoder.layers:  0 conv k5 | 2, 4 EncoderBlock | 6 conv k3
    EncoderBlock.layers: 0, 2, 4 ResidualUnit | 6 strided conv
    decoder.layers:  0 conv k3 | 2, 4 DecoderBlock | 6 conv k5
    DecoderBlock.layers: 0 transposed conv | 2, 4, 6 ResidualUnit
    ResidualUnit.layers: 0 causal conv k3 | 2 conv k1
    quantizer._codebook.{embed, cluster_size, embed_avg, initted}

(with n strides, the blocks sit at 2, 4, ..., 2n and the last conv at
2n + 2). ``dtype`` is the convs' compute dtype (``ops/conv.py``); the
quantizer and the losses run in f32. ``remat``, read at each forward,
recomputes the encoder's and the decoder's activations in the backward;
the quantizer runs outside the recompute, so its EMA update, k-means and
draws happen once a step. Under data parallelism (``mesh.batch_shard``)
the quantizer's statistics, the perplexity and the loss's count of real
timesteps are the global batch's (``ops/vq.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from frankenstein_tpu_torch.config import VQVAEConfig
from frankenstein_tpu_torch.models.layers import run_block
from frankenstein_tpu_torch.ops.conv import CausalConv1d, CausalConvTranspose1d
from frankenstein_tpu_torch.ops.vq import VectorQuantize, codebook_perplexity
from frankenstein_tpu_torch.parallel import mesh as mesh_lib


class ResidualUnit(nn.Module):
    """x + conv1x1(elu(causal conv k3 (x)))."""

    def __init__(self, channels: int, dilation: int = 1, device=None,
                 dtype=None):
        super().__init__()
        self.layers = nn.Sequential(
            CausalConv1d(channels, channels, 3, dilation=dilation,
                         device=device, dtype=dtype),
            nn.ELU(),
            CausalConv1d(channels, channels, 1, device=device, dtype=dtype))

    def forward(self, x):
        return x + self.layers(x)


def _with_elus(*modules) -> list:
    """The modules with an ELU between each two."""
    out = [modules[0]]
    for m in modules[1:]:
        out += [nn.ELU(), m]
    return out


class EncoderBlock(nn.Module):
    """3 x (ResidualUnit, ELU), then a strided causal conv."""

    def __init__(self, channels: int, stride: int, device=None, dtype=None):
        super().__init__()
        self.layers = nn.Sequential(*_with_elus(
            *[ResidualUnit(channels, device=device, dtype=dtype)
              for _ in range(3)],
            CausalConv1d(channels, channels, 2 * stride, stride=stride,
                         device=device, dtype=dtype)))

    def forward(self, x):
        return self.layers(x)


class DecoderBlock(nn.Module):
    """A transposed-conv upsample, then 3 x (ELU, ResidualUnit)."""

    def __init__(self, channels: int, stride: int, device=None, dtype=None):
        super().__init__()
        self.layers = nn.Sequential(*_with_elus(
            CausalConvTranspose1d(channels, channels, 2 * stride,
                                  stride=stride, device=device, dtype=dtype),
            *[ResidualUnit(channels, device=device, dtype=dtype)
              for _ in range(3)]))

    def forward(self, x):
        return self.layers(x)


class ConvEncoder(nn.Module):
    """[B, T, n_electrodes] -> [B, T / prod(strides), D]."""

    def __init__(self, cfg: VQVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layers = nn.Sequential(*_with_elus(
            CausalConv1d(cfg.n_electrodes, cfg.C, 5, **kw),
            *[EncoderBlock(cfg.C, s, **kw) for s in cfg.strides],
            CausalConv1d(cfg.C, cfg.D, 3, **kw)))

    def forward(self, x):
        return self.layers(x)


class ConvDecoder(nn.Module):
    """[B, T / prod(strides), D] -> [B, T, n_electrodes]."""

    def __init__(self, cfg: VQVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layers = nn.Sequential(*_with_elus(
            CausalConv1d(cfg.D, cfg.C, 3, **kw),
            *[DecoderBlock(cfg.C, s, **kw) for s in reversed(cfg.strides)],
            CausalConv1d(cfg.C, cfg.n_electrodes, 5, **kw)))

    def forward(self, x):
        return self.layers(x)


def masked_l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """L1 averaged over the timesteps that are not padding (a row of ``gt``
    that is all zero is padding, found on ``gt`` as given: bf16 under mixed
    precision). Under ``mesh.batch_shard`` the count of real timesteps is
    the global batch's and the loss is scaled by the group size (this
    rank's share of the global loss, as ``gpt2.cross_entropy_ignore``
    takes it)."""
    real = ~torch.all(gt == 0, dim=-1)                      # [B, T]
    per_row = torch.mean(torch.abs(pred.float() - gt.float()), dim=-1)
    shard = mesh_lib.current_batch_shard()
    denom = torch.clamp_min(mesh_lib.global_sum(real.sum()), 1)
    return torch.sum(per_row * real) * (shard.size if shard else 1) / denom


class SoundStream(nn.Module):
    """``loss, recon = model(x, targets=None, train=..., generator=...,
    date_info=None)``: the masked L1 reconstruction loss plus the
    commitment loss, and the reconstruction [B, T, C]. Each forward leaves
    ``aux``: ``perplexity``, ``rec_loss`` and ``commit_loss`` (detached
    scalars), the values the trainer logs. ``generator`` draws the
    quantizer's k-means and refresh rows in train mode."""

    needs_labels = False

    def __init__(self, cfg: VQVAEConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConvEncoder(cfg, device, dtype)
        self.quantizer = VectorQuantize(cfg, device=device)
        self.decoder = ConvDecoder(cfg, device, dtype)
        self.remat = False
        self.aux: dict = {}

    def forward(self, x: torch.Tensor, targets=None, *, train: bool = False,
                generator: Optional[torch.Generator] = None, date_info=None):
        e = run_block(self.encoder, x, remat=self.remat)
        quantized, indices, commit_loss = self.quantizer(
            e, train=train, generator=generator)
        recon = run_block(self.decoder, quantized, remat=self.remat)
        rec_loss = masked_l1_loss(recon, x)
        self.aux = {
            "perplexity": codebook_perplexity(indices,
                                              self.cfg.codebook_size),
            "rec_loss": rec_loss.detach(),
            "commit_loss": commit_loss.detach()}
        return rec_loss + commit_loss, recon

    @torch.no_grad()
    def get_quantize_vectors(self, x: torch.Tensor):
        """Token export for downstream LMs: (indices [B, T'], quantized
        [B, T', D])."""
        quantized, indices, _ = self.quantizer(self.encoder(x), train=False)
        return indices, quantized
