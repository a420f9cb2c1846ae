"""Brain -> text prediction: signal window in, sentence out
(``frankenstein_tpu/decode/pipeline.py``).

Seeds each sentence with <|endoftext|>, encodes the window, samples up to
25 tokens with top-k 10 on the KV-cached decode, and trims at the stop
token. Beams and rescoring are not ported yet.
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

    ``model`` is used as given: cast it with ``cast_params_for_inference``
    first to serve in bf16. ``int8_weights=True`` streams w8a16 decode
    weights, quantized once here. Each call draws from its own generator,
    seeded from ``seed`` and the call count."""
    if beam_width > 1 or rescorer is not None:
        raise NotImplementedError(
            "beam search and rescoring are not ported yet (beams need kernel "
            "K3; ROADMAP.md, modules to port: beams and predictor)")
    if int8_kv:
        raise NotImplementedError(
            "int8_kv: the int8-KV mode of K2 is not ported yet "
            "(ROADMAP.md, kernel queue: K2 int8 KV)")
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
        toks = sampling.generate(model, idx0, prefix, gen,
                                 max_new_tokens=max_new_tokens,
                                 temperature=temperature, top_k=top_k,
                                 qweights=qweights)
        return [tokenizer.decode(t, skip_special_tokens=True)
                for t in sampling.trim_at_eot(toks, eot_id)]

    return predict
