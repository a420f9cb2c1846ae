"""KV-cached top-k sampling and greedy decoding
(``frankenstein_tpu/decode/sampling.py``: ``generate``, ``_sample_scan``).

One prefill fills a fixed-shape cache, then each token costs one
``decode_step`` (kernel K2 on the card). Randomness comes from a
``torch.Generator``; top-k is exact (the JAX package draws its candidates
with ``approx_max_k``), so sampled tokens match the JAX package in
distribution, not token for token. Beams are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _round_cache_len(n: int, mult: int = 16) -> int:
    """Round the KV-cache length up to a multiple of ``mult``; padding rows
    are masked out."""
    return -(-n // mult) * mult


def decode_weights(model, int8_weights: bool) -> dict:
    """The stacked decode weights K2 streams: bf16 in the model's dtype, or
    w8a16 int8 codes with per-(layer, out-lane) scales."""
    from frankenstein_tpu_torch.models import gpt2
    gpt = model.llm_model if hasattr(model, "llm_model") else model
    if int8_weights:
        return gpt2.quantize_decode_weights(gpt, gpt.dtype)
    return gpt2.stack_decode_weights(gpt)


def quantize_serving_weights(model) -> dict:
    """Precompute the w8a16 decode weights ONCE for a serving loop; pass the
    result as ``qweights=`` to ``generate``."""
    return decode_weights(model, int8_weights=True)


def _pick(logits, generator, *, temperature: float, top_k: Optional[int],
          greedy: bool):
    logits = logits.float() / temperature
    if greedy:
        return torch.argmax(logits, dim=-1)
    if top_k is not None and top_k < logits.shape[-1]:
        vals, idx = torch.topk(logits, top_k, dim=-1)
        choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                                   generator=generator)
        return torch.gather(idx, -1, choice)[:, 0]
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


@torch.no_grad()
def _sample_scan(model, logits, cache, length: int, generator, *,
                 qweights: dict, max_new_tokens: int,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 greedy: bool = False):
    """Draw a token from ``logits``, step the model, repeat. Returns
    [B, max_new_tokens] int64 ids."""
    toks = []
    for _ in range(max_new_tokens):
        tok = _pick(logits, generator, temperature=temperature, top_k=top_k,
                    greedy=greedy)
        toks.append(tok)
        logits, cache, length = model.decode_step(tok, cache, length,
                                                  qweights)
    return torch.stack(toks, dim=1)


@torch.no_grad()
def generate(model, idx0, prefix, generator=None, *, max_new_tokens: int,
             temperature: float = 1.0, top_k: Optional[int] = None,
             greedy: bool = False, int8_kv: bool = False,
             int8_weights: bool = False, qweights: Optional[dict] = None):
    """Top-k sampling (or greedy) with a KV cache.

    idx0: [B, T0] prompt ids; prefix: [B, P, n_embd] soft prompt or None.
    ``int8_weights=True`` streams w8a16 weights, quantized here unless a
    precomputed ``qweights`` is given. Returns [B, max_new_tokens]."""
    if int8_kv:
        raise NotImplementedError(
            "int8_kv: the int8-KV mode of K2 is not ported yet "
            "(ROADMAP.md, kernel queue: K2 int8 KV)")
    max_len = _round_cache_len(
        idx0.shape[1] + (prefix.shape[1] if prefix is not None else 0)
        + max_new_tokens + 1)
    cache = model.init_decode_cache(idx0.shape[0], max_len)
    logits, cache, length = model.prefill(idx0, prefix, cache)
    if qweights is None:
        qweights = decode_weights(model, int8_weights)
    return _sample_scan(model, logits, cache, length, generator,
                        qweights=qweights, max_new_tokens=max_new_tokens,
                        temperature=temperature, top_k=top_k, greedy=greedy)


def trim_at_eot(tokens, eot_id: int):
    """Host-side: cut each row at the first eot."""
    out = []
    for row in np.asarray(torch.as_tensor(tokens).cpu()):
        stops = np.where(row == eot_id)[0]
        out.append(list(row[: stops[0]] if len(stops) else row))
    return out
