"""BrainFormer encoder, MAE pretrainer, Perceiver resampler and its L1
regression head (``frankenstein_tpu/models/brainformer.py``:
``to_patches``, ``from_patches``, ``Encoder``, ``masking_indices``,
``MAE``, ``BrainEncoder``, ``BrainFormer``).

The 6144-token slab-causal encoder attention runs kernel K1 on the card
(K10, int8 QK scores, with ``qk_int8``), and its backward kernel K4. The
MAE encodes only the tokens it keeps, in the "gathered_slab" mode (kernel
K6), and decodes all tokens with dense attention (kernel K7), both forward
and backward. ``dtype`` is the compute dtype (``models/layers.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from frankenstein_tpu_torch.config import MAEConfig, PerceiverConfig
from frankenstein_tpu_torch.models.layers import (Block, CrossBlock,
                                                  LayerNorm, linear,
                                                  run_block)
from frankenstein_tpu_torch.ops import rope as rope_ops
from frankenstein_tpu_torch.parallel import mesh as mesh_lib


def to_patches(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, T, C] -> [B, (T/p * C), p], token order (time-slab, electrode)."""
    b, t, c = x.shape
    x = x.reshape(b, t // patch_size, patch_size, c).permute(0, 1, 3, 2)
    return x.reshape(b, (t // patch_size) * c, patch_size)


def from_patches(tokens: torch.Tensor, patch_size: int,
                 n_electrodes: int) -> torch.Tensor:
    """Inverse of ``to_patches``: [B, (t c), p] -> [B, (t p), c]."""
    b, n, p = tokens.shape
    t = n // n_electrodes
    x = tokens.reshape(b, t, n_electrodes, p).permute(0, 1, 3, 2)
    return x.reshape(b, t * p, n_electrodes)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, F] rows at idx [B, M] -> [B, M, F]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _put(x: torch.Tensor, idx: torch.Tensor, rows) -> torch.Tensor:
    """x with rows idx [B, M] replaced by ``rows`` ([B, M, F] or a
    scalar), out of place (differentiable in both)."""
    where = idx[..., None].expand(-1, -1, x.shape[-1])
    return torch.scatter(x, 1, where, rows)


class Encoder(nn.Module):
    """Patch + embed + space embedding + slab-causal transformer. Submodules
    sit under ``transformer`` as in the reference's state dict.
    ``cfg.qk_int8`` reaches the blocks of ``forward`` (kernel K10), as the
    JAX ``Encoder.__call__`` passes it; ``forward_subset``, the MAE's
    kept-token path, passes nothing and computes exact attention, as the
    JAX package's does. With ``cfg.n_sessions`` > 0 the encoder holds a
    ``date_embedding`` [n_sessions, dim], and a ``date_info`` [B] of
    session ids adds row ``date_info % n_sessions`` to each sample's
    tokens."""

    def __init__(self, cfg: MAEConfig, device=None, dtype=None):
        super().__init__()
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
        if cfg.n_sessions:
            self.date_embedding = nn.Parameter(
                torch.zeros(cfg.n_sessions, cfg.dim, device=device))

    def embed_tokens(self, patches: torch.Tensor, positions=None,
                     date_info=None) -> torch.Tensor:
        """[B, N, p] patches -> [B, N, dim]: the patch embedding plus the
        per-electrode embedding tiled over time slabs, at the last N
        positions, or at ``positions`` [B, N] (the MAE's kept tokens),
        plus each sample's session row where ``date_info`` is given."""
        c = self.cfg
        tok = linear(patches, self.transformer["emb"], self.compute_dtype)
        space = self.space_embedding.repeat(1, c.n_patches_per_channel,
                                            1).to(tok.dtype)
        if positions is None:
            tok = tok + space[:, -tok.shape[1]:]
        else:
            tok = tok + space[0][positions]
        if c.n_sessions and date_info is not None:
            rows = torch.as_tensor(date_info, device=tok.device).long()
            date = self.date_embedding[rows % c.n_sessions].to(tok.dtype)
            tok = tok + date[:, None, :]
        return tok

    def forward(self, x: torch.Tensor, remat: bool = False,
                date_info=None) -> torch.Tensor:
        """x: [B, T, C] signal -> [B, n_tokens, dim] context. ``remat``
        recomputes each block's activations in the backward.

        With ``cfg.seq_parallel`` inside ``ring_attention.seq_group(g)``
        (the JAX package's ambient "seq" mesh), each rank of g carries its
        n-th of the tokens (in rank order; the count must divide) through
        the blocks, RoPE at their global positions, the slab attention round
        the ring, and the output is gathered whole (differentiably): the
        one-device encoder's. The blocks' and ``ln_f``'s parameter
        gradients are then each rank's share, summed by ``mesh.sum_grads``
        (the embedding's come whole on every rank)."""
        from frankenstein_tpu_torch.parallel import ring_attention
        c = self.cfg
        tok = self.embed_tokens(to_patches(x, c.patch_size),
                                date_info=date_info)
        rope = rope_ops.build_rope_cache(c.head_dim, c.block_size,
                                         c.rope_theta, device=x.device)
        group = ring_attention.ambient_seq_group() if c.seq_parallel else None
        if group is not None:
            n, t = mesh_lib.group_size(group), tok.shape[1]
            if t % n:
                raise ValueError(f"{t} tokens do not split over a sequence "
                                 f"group of {n}")
            r, t_loc = mesh_lib.group_rank(group), t // n
            rope = rope[-t:][r * t_loc:(r + 1) * t_loc]
            tok = ring_attention.scatter_to_group(tok, group, 1)
        for block in self.transformer["h"]:
            tok = run_block(block, tok, remat=remat, mask_mode="slab",
                            tok_per_time=c.n_electrodes, rope=rope,
                            qk_int8=c.qk_int8, ring=group)
        out = self.transformer["ln_f"](tok)
        return (out if group is None
                else mesh_lib.gather_from_group(out, group, 1))

    def forward_subset(self, patches: torch.Tensor, positions: torch.Tensor,
                       rope_cache: torch.Tensor, remat: bool = False,
                       date_info=None) -> torch.Tensor:
        """Encode only the kept tokens (the MAE path): patches [B, N, p] at
        ``positions`` [B, N] (sorted ascending) -> [B, N, dim]. Each block
        attends in the "gathered_slab" mode (kernel K6) with the rope rows
        of the kept positions."""
        c = self.cfg
        tok = self.embed_tokens(patches, positions, date_info)
        rope = rope_ops.rope_for_positions(rope_cache, positions)
        for block in self.transformer["h"]:
            tok = run_block(block, tok, remat=remat,
                            mask_mode="gathered_slab", positions=positions,
                            tok_per_time=c.n_electrodes, rope=rope)
        return self.transformer["ln_f"](tok)


def masking_indices(generator, batch: int, n_tokens: int,
                    masking_ratio: float, device=None):
    """Sorted (masked, kept) index sets of fixed sizes, int(ratio * n) and
    the rest: the argsort of uniforms drawn from ``generator`` (on
    ``device``, the generator's own by default)."""
    device = device if device is not None else (
        generator.device if generator is not None else None)
    num_masked = int(masking_ratio * n_tokens)
    noise = mesh_lib.global_rows(
        lambda n: torch.rand(n, n_tokens, generator=generator,
                             device=device), batch)
    perm = torch.argsort(noise, dim=-1)
    return (torch.sort(perm[:, :num_masked], dim=-1).values,
            torch.sort(perm[:, num_masked:], dim=-1).values)


class MAE(nn.Module):
    """Masked-autoencoder pretrainer over the encoder. Submodules are named
    as ``import_reference.export_mae`` writes them: ``encoder``,
    ``decoder.h.{i}``, ``mask_token``, ``decoder_pos_emb``, ``to_signals``.
    ``remat``, read at each forward, recomputes every block's activations
    in the backward."""

    def __init__(self, cfg: MAEConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.remat = False
        self.encoder = Encoder(cfg, device, dtype)
        self.decoder = nn.ModuleDict({"h": nn.ModuleList(
            Block(cfg.decoder_dim, cfg.n_heads, cfg.head_dim, cfg.hidden_dim,
                  device, dtype) for _ in range(cfg.n_dec_layers))})
        self.mask_token = nn.Parameter(torch.zeros(cfg.decoder_dim,
                                                   device=device))
        self.decoder_pos_emb = nn.Embedding(cfg.block_size, cfg.decoder_dim,
                                            device=device)
        self.to_signals = nn.Linear(cfg.decoder_dim, cfg.patch_size,
                                    device=device)

    needs_labels = False    # the trainer passes it no targets

    def forward(self, x, targets=None, train: bool = False,
                generator=None, date_info=None, indices=None,
                masking_ratio=None, return_preds: bool = False):
        """x: [B, T, C] signal; ``targets`` and ``train`` are ignored (the
        trainer's uniform contract; the MAE has no dropout); ``date_info``
        [B] picks each sample's session row (``cfg.n_sessions``). The mask is
        drawn from ``generator`` (on the model's device), or given as
        ``indices`` = (masked, kept), sorted [B, M] and [B, N - M].
        Returns (loss, None), the mean squared error over the masked
        patches, or with ``return_preds`` (loss, recon, binary): the window
        with its masked patches predicted, and 1 where they were masked,
        both [B, T, C]."""
        c = self.cfg
        ratio = c.masking_ratio if masking_ratio is None else masking_ratio
        patches = to_patches(x, c.patch_size)              # [B, N, p]
        b, n_tokens, _ = patches.shape
        if indices is None:
            indices = masking_indices(generator, b, n_tokens, ratio,
                                      device=x.device)
        masked, kept = indices
        rope_cache = rope_ops.build_rope_cache(c.head_dim, c.block_size,
                                               c.rope_theta, device=x.device)

        # the encoder sees only the kept tokens (25% at the default ratio)
        encoded = self.encoder.forward_subset(_take(patches, kept), kept,
                                              rope_cache, self.remat,
                                              date_info)

        # the decoder sees every token: the encoded ones at their positions,
        # the mask token elsewhere, plus the position embedding in natural
        # token order (the JAX package's alignment)
        dec = self.mask_token.to(encoded.dtype).expand(b, n_tokens, -1)
        dec = _put(dec, kept, encoded)
        dec = dec + self.decoder_pos_emb.weight[None, :n_tokens].to(
            dec.dtype)
        for block in self.decoder["h"]:
            dec = run_block(block, dec, remat=self.remat)   # dense: K7

        pred = linear(_take(dec, masked), self.to_signals,
                      self.compute_dtype)
        loss = torch.mean(torch.square(pred.float()
                                       - _take(patches, masked).float()))
        if not return_preds:
            return loss, None
        recon = _put(patches, masked, pred.to(patches.dtype))
        binary = _put(torch.zeros_like(patches), masked, 1.0)
        return (loss, from_patches(recon, c.patch_size, c.n_electrodes),
                from_patches(binary, c.patch_size, c.n_electrodes))


class Perceiver(nn.Module):
    """The resampler's blocks, final norm and output head (``perceiver.*``
    in the reference's state dict; the head is ``to_words`` in the Franky
    notebook's variant and ``to_motion`` in the reference's BrainFormer)."""

    def __init__(self, cfg: PerceiverConfig, device=None, dtype=None,
                 head: str = "to_words"):
        super().__init__()
        self.h = nn.ModuleList(
            CrossBlock(cfg.dim, cfg.n_heads, cfg.head_dim, cfg.hidden_dim,
                       device, dtype) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.dim, device=device)
        self.head = head
        self.add_module(head, nn.Linear(cfg.dim, cfg.output_dim,
                                        device=device))


class BrainEncoder(nn.Module):
    """Encoder + Perceiver resampler -> n_output_tokens vectors of
    output_dim; ``head`` names the output projection (``Perceiver``)."""

    def __init__(self, cfg: PerceiverConfig, device=None, dtype=None,
                 head: str = "to_words"):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.encoder = Encoder(cfg.encoder, device, dtype)
        self.learnable_queries = nn.Parameter(
            torch.zeros(1, cfg.n_output_tokens, cfg.dim, device=device))
        self.perceiver = Perceiver(cfg, device, dtype, head)

    def forward(self, x: torch.Tensor, remat: bool = False,
                date_info=None) -> torch.Tensor:
        """x: [B, T, C] -> [B, n_output_tokens, output_dim]; ``date_info``
        [B] picks each sample's session row (``cfg.encoder.n_sessions``)."""
        c = self.cfg
        cdt = self.compute_dtype or self.learnable_queries.dtype
        context = self.encoder(x, remat, date_info)
        q = self.learnable_queries.to(cdt).expand(x.shape[0], -1, -1)
        rope = rope_ops.build_rope_cache(c.head_dim, c.n_output_tokens,
                                         c.rope_theta, device=x.device)
        for block in self.perceiver.h:
            q = run_block(block, q, context, remat=remat, sa_rope=rope)
        head = getattr(self.perceiver, self.perceiver.head)
        return linear(self.perceiver.ln_f(q), head, self.compute_dtype)


class BrainFormer(nn.Module):
    """A BrainEncoder (``brain``, head ``to_motion``) with an L1 regression
    loss over float targets of the prediction's shape [B, n_output_tokens,
    output_dim]. Returns (loss, pred), or (None, pred) without targets.
    ``remat``, read at each forward, recomputes every block's activations
    in the backward."""

    def __init__(self, cfg: PerceiverConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.remat = False
        self.brain = BrainEncoder(cfg, device, dtype, head="to_motion")

    def forward(self, x, targets=None, train: bool = False,
                generator=None, date_info=None):
        """x: [B, T, C] signal; ``train`` and ``generator`` are ignored
        (no dropout)."""
        pred = self.brain(x, self.remat, date_info)
        if targets is None:
            return None, pred
        return torch.mean(torch.abs(pred.float() - targets.float())), pred
