"""End-to-end WER evaluation (``frankenstein_tpu/eval/evaluate.py``):
decode every trial, normalize, score. ``evaluate_franky_wer`` serves the
encoder-prefix models through their predictor; ``evaluate_seq2seq_wer``
the whisper path, greedy or with beams, over its prepared inputs."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from frankenstein_tpu_torch.config import GPT2_EOT
from frankenstein_tpu_torch.data.text import process_string
from frankenstein_tpu_torch.eval.wer import corpus_wer


def evaluate_franky_wer(model, dataset, tokenizer, *,
                        batch_size: int = 32, max_new_tokens: int = 25,
                        beam_width: int = 0, top_k: int = 10,
                        eot_id: int = GPT2_EOT, seed: int = 0,
                        rescorer=None,
                        normalize: Callable = process_string):
    """Decode every trial through ``make_franky_predictor``, normalize,
    return (corpus WER, predictions). The final partial batch is padded
    with copies of its last trial, so every call sees ``batch_size`` rows.
    ``rescorer`` (``(lm_module[, alpha])``) re-ranks the beams' n-best
    lists, as in ``make_franky_predictor``."""
    from frankenstein_tpu_torch.decode.pipeline import make_franky_predictor
    predict = make_franky_predictor(model, tokenizer,
                                    max_new_tokens=max_new_tokens,
                                    top_k=top_k, beam_width=beam_width,
                                    eot_id=eot_id, seed=seed,
                                    rescorer=rescorer)
    preds = []
    n = len(dataset)
    for s in range(0, n, batch_size):
        ids = range(s, min(s + batch_size, n))
        xs = np.stack([dataset[i][0] for i in ids])
        pad = batch_size - xs.shape[0]
        if pad:
            xs = np.concatenate([xs, np.repeat(xs[-1:], pad, 0)])
        preds.extend(predict(xs)[:len(ids)])
    refs = [normalize(t) for t in dataset.targets]
    preds = [normalize(p) for p in preds]
    return corpus_wer(refs, preds), preds


def evaluate_seq2seq_wer(model, mels, sentences, tokenizer, *,
                         start_id: Optional[int] = None, batch_size: int = 16,
                         max_new_tokens: int = 32,
                         eot_id: Optional[int] = None, beam_width: int = 0,
                         length_penalty: float = 1.0, int8_kv: bool = False,
                         normalize: Callable = process_string):
    """The whisper path's WER: a cached decode of every input of ``mels``
    [N, n_mels, frames] (numpy) on the model's device, greedy, or a
    deterministic beam search with ``beam_width > 1`` ranked by
    ``score / gen_len**length_penalty``. Returns (corpus WER,
    predictions).

    With ``start_id=None`` the decoder's prompt is the model's
    ``sot_prompt()`` and each row is cut at its ``eot_id()`` (or at
    ``eot_id``); with a ``start_id`` the prompt is that token, and rows are
    cut only at a given ``eot_id``. The last partial batch is padded with
    copies of its last input. ``int8_kv`` quantizes the prefilled self and
    cross K/V (``quantize_whisper_cache``). Predictions are decoded with
    ``skip_special_tokens=True``, then both sides are normalized."""
    import torch

    from frankenstein_tpu_torch.decode import sampling
    from frankenstein_tpu_torch.models import whisper as whisper_lib

    if start_id is None:
        prompt = model.sot_prompt()
        eot = model.eot_id() if eot_id is None else eot_id
    else:
        prompt = (start_id,)
        eot = eot_id
    device = model.device
    preds = []
    n = mels.shape[0]
    for s in range(0, n, batch_size):
        xs = mels[s:s + batch_size]
        real = xs.shape[0]
        if real < batch_size:
            xs = np.concatenate([xs, np.repeat(xs[-1:], batch_size - real,
                                               0)])
        tok0 = torch.tensor(prompt, device=device).repeat(batch_size, 1)
        cache = whisper_lib.init_whisper_cache(
            model.cfg, batch_size, len(prompt) + max_new_tokens + 2,
            device=device)
        logits, cache, length = model.prefill(
            tok0, torch.as_tensor(xs, dtype=torch.float32, device=device),
            cache)
        if int8_kv:
            cache = whisper_lib.quantize_whisper_cache(cache)
        if beam_width > 1:
            seqs, _ = sampling.beam_from_prefill(
                model, logits, cache, length, max_new_tokens=max_new_tokens,
                beam_width=beam_width, eos_id=eot,
                length_penalty=length_penalty)
        else:
            seqs = sampling.greedy_decode_scan(
                model, logits, cache, length, max_new_tokens=max_new_tokens)
        seqs = seqs[:real].cpu().numpy()
        rows = (sampling.trim_at_eot(seqs, eot) if eot is not None
                else [list(row) for row in seqs])
        preds.extend(tokenizer.decode(list(row), skip_special_tokens=True)
                     for row in rows)
    refs = [normalize(t) for t in sentences]
    preds = [normalize(p) for p in preds]
    return corpus_wer(refs, preds), preds
