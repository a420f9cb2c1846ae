"""Brain -> text prediction: signal window in, sentence out
(``frankenstein_tpu/decode/pipeline.py``).

Seeds each sentence with <|endoftext|>, encodes the window, decodes up to
25 tokens on the KV-cached decode (top-k 10 sampling, or EOS-aware beams
with length penalty 1.0, optionally re-ranked by an LM's n-best
rescoring), and trims at the stop token. Serves Franky (GPT-2, kernel K2)
and FrankyLlama (LLaMA, kernel K5) alike.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from frankenstein_tpu_torch.config import GPT2_EOT
from frankenstein_tpu_torch.decode import sampling


def cast_params_for_inference(model, dtype=torch.bfloat16):
    """Cast the whole model to the compute dtype once (in place)."""
    return model.to(dtype)


def make_franky_predictor(model, tokenizer, *, max_new_tokens: int = 25,
                          temperature: float = 1.0,
                          top_k: Optional[int] = 10, beam_width: int = 0,
                          eot_id: int = GPT2_EOT, seed: int = 0,
                          rescorer=None, int8_weights: bool = False,
                          int8_kv: bool = False) -> Callable:
    """Returns predict(xs [B, T, C]) -> list[str] (length B).

    ``model`` (a Franky or a FrankyLlama) is used as given: cast it with
    ``cast_params_for_inference`` first to serve in bf16. ``beam_width > 1``
    decodes with EOS-aware beams (``sampling.beam_search``, length penalty
    1.0) instead of top-k sampling. ``rescorer``: ``(lm_module,)`` or
    ``(lm_module, alpha)`` (alpha 0.5 by default), a ``Llama`` or a
    FrankyLlama; with beams, the whole n-best list is re-ranked by
    ``alpha`` * the LM's length-normalised log-probability (no brain
    prefix) + (1 - alpha) * the beam score (``models/llama.py:
    rescore_candidates``). ``int8_weights=True`` streams w8a16 decode
    weights, quantized once here; ``int8_kv=True`` quantizes each request's
    prefilled KV cache to int8, on both branches. Each call draws from its
    own generator, seeded from ``seed`` and the call count."""
    from frankenstein_tpu_torch.models import llama
    qweights = sampling.decode_weights(model, int8_weights)
    calls = 0

    def predict(xs) -> List[str]:
        nonlocal calls
        calls += 1
        x = torch.as_tensor(xs, dtype=torch.float32, device=model.device)
        b = x.shape[0]
        prefix = model.encode(x)
        idx0 = torch.full((b, 1), eot_id, dtype=torch.long,
                          device=model.device)
        gen = torch.Generator(device=model.device).manual_seed(
            seed * 1_000_003 + calls)
        if beam_width > 1:
            toks, scores = sampling.beam_search(
                model, idx0, prefix, max_new_tokens=max_new_tokens,
                beam_width=beam_width, eos_id=eot_id, length_penalty=1.0,
                qweights=qweights, int8_kv=int8_kv,
                n_best=rescorer is not None)
            if rescorer is not None:
                alpha = rescorer[1] if len(rescorer) > 1 else 0.5
                cands = llama.candidates_from_beams(toks, eot_id)
                best, _ = llama.rescore_candidates(
                    rescorer[0], cands, decoder_scores=scores, alpha=alpha)
                toks = toks[torch.arange(b, device=toks.device), best]
        else:
            toks = sampling.generate(model, idx0, prefix, gen,
                                     max_new_tokens=max_new_tokens,
                                     temperature=temperature, top_k=top_k,
                                     qweights=qweights, int8_kv=int8_kv)
        return [tokenizer.decode(t, skip_special_tokens=True)
                for t in sampling.trim_at_eot(toks, eot_id)]

    return predict
