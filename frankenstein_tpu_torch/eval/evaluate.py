"""End-to-end WER evaluation (``frankenstein_tpu/eval/evaluate.py``):
decode every trial, normalize, score. The whisper path's evaluation
(``evaluate_seq2seq_wer``) comes with the whisper slice."""

from __future__ import annotations

from typing import Callable

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
