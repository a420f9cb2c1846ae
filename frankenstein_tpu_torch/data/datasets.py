"""Dataset construction: competitionData .mat ingest, per-block z-score,
padding, tokenization — plus a synthetic generator with the same schema so
everything runs without the (non-redistributable) dataset.

A numpy-only copy of ``frankenstein_tpu/data/datasets.py`` (the port may not
import the JAX package); ``tests/test_torch_eval.py`` holds it to the
original.

Host-side re-design of reference:utils/data_utils.py:44-344. The scipy .mat
reader stays on the host (I/O); normalization math is plain numpy with
sklearn-identical semantics (ddof=0), mirrored on device by
ops/preprocess.py.
"""

from __future__ import annotations

import os
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from frankenstein_tpu_torch.config import (IGNORE_INDEX, MAX_INPUT_LEN,
                                           MAX_TOKENS, N_ELECTRODES)
from frankenstein_tpu_torch.data.text import pad_token_list

# 24 recording sessions (reference:utils/data_utils.py:14-37)
DATE_TO_INDEX = {f"t12.2022.{md}": i for i, md in enumerate([
    "04.28", "05.05", "05.17", "05.19", "05.24", "05.26",
    "06.02", "06.07", "06.14", "06.16", "06.21", "06.23",
    "06.28", "07.05", "07.14", "07.21", "07.27", "07.29",
    "08.02", "08.11", "08.13", "08.18", "08.23", "08.25"])}


# ---------------------------------------------------------------------------
# normalization (reference:data_utils.py:44-156)
# ---------------------------------------------------------------------------

def _group_by_block(idx_list) -> Dict:
    groups = defaultdict(list)
    for i, b in enumerate(idx_list):
        groups[int(b)].append(i)
    return groups


def z_score_per_block_scaling(brain_list: Sequence[np.ndarray],
                              idx_list: Sequence[int]) -> List[np.ndarray]:
    """Per-block StandardScaler (fit on all trials of a block concatenated,
    reference:data_utils.py:78-109)."""
    out: List = [None] * len(brain_list)
    for block, ids in _group_by_block(idx_list).items():
        cat = np.concatenate([brain_list[i] for i in ids], axis=0)
        mean = cat.mean(axis=0, keepdims=True)
        std = cat.std(axis=0, keepdims=True)
        std[std == 0] = 1.0
        for i in ids:
            out[i] = ((brain_list[i] - mean) / std).astype(np.float32)
    return out


def min_max_per_block_scaling(brain_list, idx_list) -> List[np.ndarray]:
    """Per-block MinMaxScaler (reference:data_utils.py:44-75)."""
    out: List = [None] * len(brain_list)
    for block, ids in _group_by_block(idx_list).items():
        cat = np.concatenate([brain_list[i] for i in ids], axis=0)
        lo = cat.min(axis=0, keepdims=True)
        rng = cat.max(axis=0, keepdims=True) - lo
        rng[rng == 0] = 1.0
        for i in ids:
            out[i] = ((brain_list[i] - lo) / rng).astype(np.float32)
    return out


def process_signal(voltage_list, spikes_list, block_list,
                   smooth_sigma: float = 1.0) -> List[np.ndarray]:
    """Alternate 512-channel path: concat spikePow+tx4, block z-score,
    Gaussian smooth over time (reference:data_utils.py:115-156)."""
    from scipy.ndimage import gaussian_filter1d
    concat = [np.concatenate([v, s], axis=1)
              for v, s in zip(voltage_list, spikes_list)]
    normed = z_score_per_block_scaling(concat, block_list)
    return [gaussian_filter1d(x, sigma=smooth_sigma, axis=0).astype(np.float32)
            for x in normed]


def pad_truncate_brain_list(brain_list, max_length: int = MAX_INPUT_LEN):
    """Zero-pad / truncate each [T, C] to [max_length, C]
    (reference:data_utils.py:243-267)."""
    out = []
    for brain in brain_list:
        t = brain.shape[0]
        if t >= max_length:
            out.append(np.ascontiguousarray(brain[:max_length]))
        else:
            out.append(np.pad(brain, ((0, max_length - t), (0, 0))))
    return out


# ---------------------------------------------------------------------------
# .mat ingest (reference:data_utils.py:159-199)
# ---------------------------------------------------------------------------

def process_file(data_file: Path, mode: str = "voltages",
                 use_native: Optional[bool] = None):
    """One session .mat -> (brain_list, sentence_list, date_list).

    mode: 'voltages' (256ch spikePow z-score, the reference's active path,
    reference:data_utils.py:174-181) or 'concat512' (spikePow+tx4 + smoothing,
    the bypassed alternative, reference:data_utils.py:115-156).

    use_native: route normalization/smoothing through the C++ host library
    (data/native.py, built from native/preprocess.cpp — single-pass fused
    z-score vs numpy's concat+mean+std temporaries). Default: the
    FK_NATIVE_PREPROC env var; silently numpy when the lib isn't built.
    """
    import scipy.io
    data = scipy.io.loadmat(data_file)
    date = Path(data_file).stem
    n_trials = data["blockIdx"].shape[0]
    voltage_list = list(data["spikePow"][0][:])
    spikes_list = list(data["tx4"][0][:])
    block_list = data["blockIdx"][:, 0]
    sentence_list = [str(s).strip() for s in data["sentenceText"]]

    if use_native is None:
        use_native = os.environ.get("FK_NATIVE_PREPROC", "") == "1"
    if use_native:
        from frankenstein_tpu_torch.data import native as native_lib
        if mode == "concat512":
            concat = [np.concatenate([v, s], axis=1)
                      for v, s in zip(voltage_list, spikes_list)]
            normed = native_lib.z_score_per_block_scaling(concat, block_list)
            brain_list = [native_lib.gaussian_smooth(x, 1.0) for x in normed]
        else:
            brain_list = native_lib.z_score_per_block_scaling(
                voltage_list, block_list)
    elif mode == "concat512":
        brain_list = process_signal(voltage_list, spikes_list, block_list)
    else:
        brain_list = z_score_per_block_scaling(voltage_list, block_list)

    return brain_list, sentence_list, [date] * n_trials


def process_all_files(path: Path, mode: str = "voltages",
                      use_native: Optional[bool] = None):
    data = {"brain_list": [], "sentence_list": [], "date_list": []}
    for data_file in sorted(Path(path).glob("*.mat")):
        brains, sentences, dates = process_file(data_file, mode, use_native)
        data["brain_list"].extend(brains)
        data["sentence_list"].extend(sentences)
        data["date_list"].extend(dates)
    return data


# ---------------------------------------------------------------------------
# synthetic data with the competitionData schema
# ---------------------------------------------------------------------------

_WORDS = ("i you we they it this that the a to and can will want need like "
          "go see say think know good day time people right now here very "
          "much help feel home work talk hear make take give come").split()


def synthetic_trials(n_trials: int, seed: int = 0, n_electrodes: int = N_ELECTRODES,
                     min_len: int = 300, max_len: int = 919, n_blocks: int = 4):
    """Random trials shaped like the competition data: ragged [T, 256] float
    signals with block structure, plus sentences (word stats follow the
    explore_data.ipynb bounds: <=24 tokens, T<=919)."""
    rng = np.random.default_rng(seed)
    brains, sentences, blocks = [], [], []
    for i in range(n_trials):
        t = int(rng.integers(min_len, max_len + 1))
        block = int(rng.integers(0, n_blocks))
        base = rng.gamma(2.0, 1.0, size=(1, n_electrodes)) * (1 + block)
        sig = (base + rng.standard_normal((t, n_electrodes))).astype(np.float32)
        n_words = int(rng.integers(3, 12))
        sentence = " ".join(rng.choice(_WORDS, size=n_words))
        brains.append(sig)
        sentences.append(sentence)
        blocks.append(block)
    return brains, sentences, blocks


class BrainDataset:
    """Fixed-shape dataset of (input [768, 256] f32, tokens [25] i64, date_idx).

    Parity with reference:utils/data_utils.py:291-344 but returns an int
    session index instead of the raw date string (the reference's
    DATE_TO_INDEX is defined yet unused — SURVEY.md §7 caveat)."""

    def __init__(self, path: Optional[Path] = None,
                 tokenize_function: Optional[Callable] = None,
                 data: Optional[dict] = None,
                 max_input_len: int = MAX_INPUT_LEN,
                 max_tokens: int = MAX_TOKENS,
                 date_to_index: Optional[dict] = None):
        if data is None:
            assert path is not None, "need path or prebuilt data"
            data = process_all_files(Path(path))
        self.targets = data["sentence_list"]
        self.date = data["date_list"]
        self.date_to_index = date_to_index or dict(DATE_TO_INDEX)
        for d in self.date:
            self.date_to_index.setdefault(d, len(self.date_to_index))

        if tokenize_function is not None:
            self.targets_tokens = [
                np.asarray(pad_token_list(tokenize_function(t), max_tokens,
                                          IGNORE_INDEX), np.int64)
                for t in self.targets]
        else:
            self.targets_tokens = list(self.targets)

        self.inputs = pad_truncate_brain_list(data["brain_list"], max_input_len)

    @classmethod
    def synthetic(cls, n_trials: int = 64, seed: int = 0,
                  tokenize_function: Optional[Callable] = None,
                  n_electrodes: int = N_ELECTRODES, **kw):
        brains, sentences, blocks = synthetic_trials(
            n_trials, seed, n_electrodes=n_electrodes)
        brains = z_score_per_block_scaling(brains, blocks)
        data = {"brain_list": brains, "sentence_list": sentences,
                "date_list": [f"synthetic.block{b}" for b in blocks]}
        return cls(data=data, tokenize_function=tokenize_function, **kw)

    def __len__(self):
        return len(self.inputs)

    def __getitem__(self, idx: int):
        return (self.inputs[idx].astype(np.float32),
                self.targets_tokens[idx],
                self.date_to_index[self.date[idx]])

    def as_arrays(self):
        """Stack the whole dataset: (inputs [N,768,C], tokens [N,25], dates [N])."""
        x = np.stack([self.inputs[i] for i in range(len(self))]).astype(np.float32)
        if isinstance(self.targets_tokens[0], np.ndarray):
            y = np.stack(self.targets_tokens).astype(np.int64)
        else:
            y = None
        d = np.asarray([self.date_to_index[dd] for dd in self.date], np.int32)
        return x, y, d


def batch_iterator(dataset, batch_size: int, *, shuffle: bool, seed: int = 0,
                   drop_last: bool = True, epochs: Optional[int] = None):
    """Host-side batcher yielding stacked numpy batches; the trainer shards
    them onto the mesh. Replaces torch DataLoader
    (reference:utils/train_utils.py:74-91)."""
    n = len(dataset)
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        end = n - (n % batch_size) if drop_last else n
        for s in range(0, end, batch_size):
            ids = order[s:s + batch_size]
            xs, ys, ds = zip(*(dataset[int(i)] for i in ids))
            yield (np.stack(xs), np.stack(ys), np.asarray(ds, np.int32))
        epoch += 1
