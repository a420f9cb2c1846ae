"""eval.ai submission writer (reference:notebooks/submit_data.ipynb cell 0):
one normalized prediction line per held-out trial -> sub.txt.

A copy of ``frankenstein_tpu/eval/submission.py`` (framework-free; the port may not
import the JAX package).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, Sequence

from frankenstein_tpu_torch.data.text import process_string


def create_string_file(fpath, sentences: Sequence[str],
                       normalize: Callable = process_string) -> Path:
    fpath = Path(fpath)
    with open(fpath, "w", encoding="utf-8") as f:
        for s in sentences:
            f.write(normalize(s) + "\n")
    return fpath


def make_predictions(dataset, predict_fn: Callable, batch_size: int = 32):
    """predict_fn(batch_inputs [B, T, C]) -> list[str]; returns all sentences
    in dataset order (reference's make_prediction_on_dataset, implemented for
    real — the reference version is a stub returning constant text)."""
    import numpy as np
    preds = []
    n = len(dataset)
    for s in range(0, n, batch_size):
        xs = np.stack([dataset[i][0] for i in range(s, min(s + batch_size, n))])
        preds.extend(predict_fn(xs))
    return preds
