"""Prep for the whisper path (``frankenstein_tpu/data/whisper_prep.py``):
PCA of the 256 voltage channels fit on the train trials, 80 components
kept, a 2x FFT resample (50 -> 100 Hz) and zero padding to 3000 frames, a
"fake mel spectrogram" [N, 80, 3000].

The math runs on ``device`` (``ops/preprocess.py``: SVD PCA, FFT
resample); the results come back as numpy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from frankenstein_tpu_torch.ops import preprocess


def fit_pca(brain_list: Sequence[np.ndarray], n_voltage_ch: int = 256, *,
            device="cuda"):
    """PCA over every train row's first ``n_voltage_ch`` channels: (mean
    [C], all C components [C, C]) as numpy, each component up to its
    sign."""
    x = np.concatenate([b[:, :n_voltage_ch] for b in brain_list], axis=0)
    mean, comps = preprocess.pca_fit(
        torch.as_tensor(x, dtype=torch.float32, device=device), x.shape[1])
    return mean.cpu().numpy(), comps.cpu().numpy()


def prepare_brain_data_for_whisper(brain_list: Sequence[np.ndarray],
                                   pca_mean: np.ndarray,
                                   pca_components: np.ndarray,
                                   n_components: int = 80,
                                   pad_length: int = 3000,
                                   n_voltage_ch: int = 256, *,
                                   device="cuda") -> np.ndarray:
    """[N ragged [T, C]] -> [N, n_components, pad_length] f32: each trial
    projected on the first ``n_components`` components, resampled to 2T
    frames and cut or zero-padded to ``pad_length``."""
    out = np.zeros((len(brain_list), n_components, pad_length), np.float32)
    comps = torch.as_tensor(pca_components[:n_components], device=device)
    mean = torch.as_tensor(pca_mean, device=device)
    for i, data in enumerate(brain_list):
        x = torch.as_tensor(data[:, :n_voltage_ch], dtype=torch.float32,
                            device=device)
        z = preprocess.pca_transform(x, mean, comps).T          # [80, T]
        t = z.shape[1]
        z2 = preprocess.resample_fft(z, 2 * t, dim=1)           # 50 -> 100 Hz
        n = min(2 * t, pad_length)
        out[i, :, :n] = z2[:, :n].cpu().numpy()
    return out
