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


def make_predictions(dataset, predict_fn: Callable, batch_size: int = 32,
                     group=None):
    """predict_fn(batch_inputs [B, T, C]) -> list[str]; returns all sentences
    in dataset order (reference's make_prediction_on_dataset, implemented for
    real — the reference version is a stub returning constant text).

    ``group`` (a ``torch.distributed`` group of d ranks, each with the
    model): data-parallel serving. Every rank takes its rows of each batch
    (the batch padded to a multiple of d with copies of its last row),
    predicts them under ``parallel.mesh.batch_shard`` (so the MoE capacity
    and the int8 KV scales are the batch's, as a sharded JAX decode
    computes them), and the strings are gathered in order on every rank.
    Greedy and beam decodes give the one-device strings; top-k sampling
    draws per rank."""
    import numpy as np
    preds = []
    n = len(dataset)
    d = 1
    if group is not None:
        import torch.distributed as dist
        d, r = dist.get_world_size(group), dist.get_rank(group)
    for s in range(0, n, batch_size):
        xs = np.stack([dataset[i][0] for i in range(s, min(s + batch_size, n))])
        if d == 1:
            preds.extend(predict_fn(xs))
            continue
        rows = len(xs)
        per = -(-rows // d)
        xs = np.concatenate([xs, np.repeat(xs[-1:], per * d - rows, 0)])
        from frankenstein_tpu_torch.parallel import mesh as mesh_lib
        with mesh_lib.batch_shard(group):
            mine = predict_fn(xs[r * per:(r + 1) * per])
        every = [None] * d
        dist.all_gather_object(every, mine, group=group)
        preds.extend([t for part in every for t in part][:rows])
    return preds
