"""Franky: BrainEncoder prefix -> GPT-2, and FrankyLlama: the same brain
prefix -> a LLaMA (``frankenstein_tpu/models/franky.py``); FrankyLfm2: the
same prefix -> LFM2-MoE (the port's own, ``models/lfm2.py``).

The 32 Perceiver output vectors are a soft prompt for the LM. Module names
(``brain_model``, ``llm_model``) follow the reference's state dict.
``dtype`` is the compute dtype (``models/layers.py``); ``remat``, read at
each forward, recomputes every block's activations in the backward. Both
take ``date_info`` [B], the samples' session ids, which reach the
encoder's session embedding (``MAEConfig.n_sessions``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from frankenstein_tpu_torch.config import (FrankyConfig, FrankyLfm2Config,
                                           FrankyLlamaConfig, IGNORE_INDEX)
from frankenstein_tpu_torch.models.brainformer import BrainEncoder
from frankenstein_tpu_torch.models.gpt2 import GPT
from frankenstein_tpu_torch.models.lfm2 import Lfm2
from frankenstein_tpu_torch.models.llama import Llama


class _BrainPrefixLM(nn.Module):
    """A BrainEncoder whose Perceiver output is an LM's soft prompt: the
    decode surface that the generic loops in ``decode/`` call, written once
    for every composite. GPT-2 and the LLaMA keep an [L, B, S, E] cache
    with batch at axis 1, so GPT's beam reorder (kernel K3) serves both; an
    LM with another cache overrides ``reorder_cache``."""

    def __init__(self, cfg, lm: nn.Module, lm_width: int, device, dtype):
        super().__init__()
        if cfg.brain.output_dim != lm_width:
            raise ValueError(f"Perceiver output_dim ({cfg.brain.output_dim})"
                             f" must equal the LM's width ({lm_width})")
        self.cfg = cfg
        self.brain_model = BrainEncoder(cfg.brain, device, dtype)
        self.llm_model = lm

    @property
    def dtype(self) -> torch.dtype:
        return self.llm_model.dtype

    @property
    def device(self) -> torch.device:
        return self.llm_model.device

    def _padded(self, targets):
        """targets with -100 replaced by the pad id: the LM's input ids."""
        return torch.where(targets == IGNORE_INDEX,
                           torch.full_like(targets, self.cfg.pad_token_id),
                           targets)

    @torch.no_grad()
    def encode(self, x, date_info=None):
        """Brain window -> prefix vectors in the LM's embedding space."""
        return self.brain_model(x, date_info=date_info)

    def init_decode_cache(self, batch: int, max_len: int):
        return self.llm_model.init_decode_cache(batch, max_len)

    def prefill(self, idx, prefix, cache):
        return self.llm_model.prefill(idx, prefix, cache)

    def decode_step(self, token, cache, length: int,
                    qweights: Optional[dict] = None):
        return self.llm_model.decode_step(token, cache, length, qweights)

    reorder_cache = staticmethod(GPT.reorder_cache)


class Franky(_BrainPrefixLM):
    def __init__(self, cfg: FrankyConfig, device=None, dtype=None):
        super().__init__(cfg, GPT(cfg.gpt, device, dtype), cfg.gpt.n_embd,
                         device, dtype)
        self.remat = False

    def decode_step_topk(self, token, cache, length: int,
                         qweights: Optional[dict] = None, *, k: int):
        """``GPT.decode_step_topk`` (kernel K8 on the card): the compact
        top-k route of ``sampling.generate``. FrankyLlama has no such
        method, as in the JAX package, so its requests keep the dense
        route."""
        return self.llm_model.decode_step_topk(token, cache, length,
                                               qweights, k=k)

    def forward(self, x, targets, train: bool = False,
                generator: Optional[torch.Generator] = None,
                date_info=None):
        """x: [B, 768, 256] signal; targets: [B, 25] ids with -100 padding.
        Returns (loss, logits), the trainer's uniform contract. ``train``
        turns GPT dropout on, drawn from ``generator`` (a generator on the
        model's device)."""
        features = self.brain_model(x, self.remat, date_info)
        return self.llm_model(self._padded(targets), prefix=features,
                              targets=targets, train=train,
                              generator=generator, remat=self.remat)


class FrankyLlama(_BrainPrefixLM):
    """BrainEncoder prefix -> LLaMA: the north-star composite.
    ``sequence_logprob`` lets it rescore its own n-best list, conditioned
    on the brain prefix."""

    def __init__(self, cfg: FrankyLlamaConfig, device=None, dtype=None):
        super().__init__(cfg, Llama(cfg.lm, device, dtype), cfg.lm.dim,
                         device, dtype)
        self.remat = False

    def forward(self, x, targets, train: bool = False,
                generator: Optional[torch.Generator] = None,
                date_info=None):
        """x: [B, T, C] signal; targets: [B, max_tokens] ids with -100
        padding. Returns (loss, logits), the trainer's uniform contract;
        the LLaMA has no dropout, so ``train`` and ``generator`` change
        nothing."""
        features = self.brain_model(x, self.remat, date_info)
        return self.llm_model(self._padded(targets), prefix=features,
                              targets=targets, remat=self.remat)

    @torch.no_grad()
    def sequence_logprob(self, idx, prefix=None,
                         ignore_index: int = IGNORE_INDEX):
        return self.llm_model.sequence_logprob(idx, prefix,
                                               ignore_index=ignore_index)

    expand_cache = staticmethod(Llama.expand_cache)


class FrankyLfm2(_BrainPrefixLM):
    """BrainEncoder prefix -> LFM2-MoE, served (it has no training
    forward): its hybrid cache (KV rows and short-conv state) moves by the
    LM's own ``reorder_cache`` and ``expand_cache``."""

    def __init__(self, cfg: FrankyLfm2Config, device=None, dtype=None):
        super().__init__(cfg, Lfm2(cfg.lm, device, dtype),
                         cfg.lm.hidden_size, device, dtype)

    reorder_cache = staticmethod(Lfm2.reorder_cache)
    expand_cache = staticmethod(Lfm2.expand_cache)
