"""Franky: BrainEncoder prefix -> GPT-2 (``frankenstein_tpu/models/franky.py``).

The 32 Perceiver output vectors are a soft prompt for GPT-2. Module names
(``brain_model``, ``llm_model``) follow the reference's state dict.
``dtype`` is the compute dtype (``models/layers.py``); ``remat``, read at
each forward, recomputes every block's activations in the backward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from frankenstein_tpu_torch.config import FrankyConfig, IGNORE_INDEX
from frankenstein_tpu_torch.models.brainformer import BrainEncoder
from frankenstein_tpu_torch.models.gpt2 import GPT


class Franky(nn.Module):
    def __init__(self, cfg: FrankyConfig, device=None, dtype=None):
        super().__init__()
        if cfg.brain.output_dim != cfg.gpt.n_embd:
            raise ValueError("Perceiver output_dim must equal the GPT n_embd")
        self.cfg = cfg
        self.remat = False
        self.brain_model = BrainEncoder(cfg.brain, device, dtype)
        self.llm_model = GPT(cfg.gpt, device, dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.llm_model.dtype

    @property
    def device(self) -> torch.device:
        return self.llm_model.device

    def forward(self, x, targets, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: [B, 768, 256] signal; targets: [B, 25] ids with -100 padding.
        Returns (loss, logits), the trainer's uniform contract. ``train``
        turns GPT dropout on, drawn from ``generator`` (a generator on the
        model's device)."""
        features = self.brain_model(x, self.remat)
        idx = torch.where(targets == IGNORE_INDEX,
                          torch.full_like(targets, self.cfg.pad_token_id),
                          targets)
        return self.llm_model(idx, prefix=features, targets=targets,
                              train=train, generator=generator,
                              remat=self.remat)

    @torch.no_grad()
    def encode(self, x):
        """Brain window -> prefix vectors (decode-time entry)."""
        return self.brain_model(x)

    def init_decode_cache(self, batch: int, max_len: int):
        return self.llm_model.init_decode_cache(batch, max_len)

    def prefill(self, idx, prefix, cache):
        return self.llm_model.prefill(idx, prefix, cache)

    def decode_step(self, token, cache, length: int,
                    qweights: Optional[dict] = None):
        return self.llm_model.decode_step(token, cache, length, qweights)

    @staticmethod
    def reorder_cache(cache, flat_idx, group: int = 0):
        return GPT.reorder_cache(cache, flat_idx, group=group)
