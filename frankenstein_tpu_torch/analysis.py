"""Exploration utilities (``frankenstein_tpu/analysis.py``): the library form
of the reference's exploration notebooks (explore_data.ipynb,
reduce_brain_dimensionality.ipynb, explore_gpt2_nano.ipynb).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def dataset_stats(brain_list: Sequence[np.ndarray],
                  token_lists: Sequence[Sequence[int]] | None = None) -> Dict:
    """Trial-length and token-count statistics (explore_data.ipynb cell 0:
    max signal length 919, 58 trials over 768, at most 24 tokens)."""
    lengths = np.asarray([len(b) for b in brain_list])
    stats = {
        "n_trials": int(len(brain_list)),
        "max_len": int(lengths.max()) if len(lengths) else 0,
        "min_len": int(lengths.min()) if len(lengths) else 0,
        "mean_len": float(lengths.mean()) if len(lengths) else 0.0,
        "n_over_768": int((lengths > 768).sum()),
    }
    if token_lists is not None:
        tl = np.asarray([len(t) for t in token_lists])
        stats.update(max_tokens=int(tl.max()), min_tokens=int(tl.min()))
    return stats


def find_long_samples(sample_list, max_length: int) -> List[int]:
    """Indices of the trials longer than ``max_length``."""
    return [i for i, s in enumerate(sample_list) if len(s) > max_length]


def reduce_dimensionality(x: np.ndarray, n_components: int,
                          method: str = "pca") -> np.ndarray:
    """[N, C] -> [N, n_components]: PCA through the port's SVD
    (``ops/preprocess.py``, each component fixed up to its sign), or
    scikit-learn's ICA, NMF or Isomap on the host, imported when asked for
    (the reduce_brain_dimensionality.ipynb sweep). The H100 machine has no
    scikit-learn, so there only ``pca`` runs."""
    if method == "pca":
        from frankenstein_tpu_torch.ops import preprocess
        t = torch.as_tensor(np.asarray(x, np.float32))
        mean, comps = preprocess.pca_fit(t, n_components)
        return preprocess.pca_transform(t, mean, comps).numpy()
    if method == "ica":
        from sklearn.decomposition import FastICA
        return FastICA(n_components=n_components,
                       max_iter=500).fit_transform(x)
    if method == "nmf":
        from sklearn.decomposition import NMF
        x = x - x.min()
        return NMF(n_components=n_components, max_iter=500).fit_transform(x)
    if method == "isomap":
        from sklearn.manifold import Isomap
        return Isomap(n_components=n_components).fit_transform(x)
    raise ValueError(f"unknown method {method}")


def crop_gpt_layers(state: dict, n_layers: int) -> dict:
    """Layer-cutting distillation: the port's GPT state dict ``state`` with
    only its first ``n_layers`` blocks (``transformer.h.{i}.*``, i <
    n_layers) (explore_gpt2_nano.ipynb cells 19-21). Load it into a GPT of
    ``GPTConfig(n_layer=n_layers)``."""
    head = "transformer.h."
    out = {}
    for name, value in state.items():
        if name.startswith(head) and int(
                name[len(head):].split(".", 1)[0]) >= n_layers:
            continue
        out[name] = value
    return out


def crop_block_size(state: dict, cfg, block_size: int):
    """The GPT state dict with its position table cut to ``block_size``
    rows, and the config to match (reference:gpt2_model.py:218-227)."""
    assert block_size <= cfg.block_size
    out = dict(state)
    out["transformer.wpe.weight"] = state["transformer.wpe.weight"][
        :block_size]
    return out, cfg.replace(block_size=block_size)
