"""Sliding-window inference over a long recording
(``frankenstein_tpu/decode/streaming.py``).

The reference sketches streaming loops that slide a window over a long
signal (``default_generation`` / ``cache_generation``,
reference:models/brainformer.py:578-618). Here the windowing is a host
loop around the model's encode: windows go in batches of one shape (the
last batch padded with its last window), so every call sees the same
shapes, and on the card Franky's encode runs kernels K1 and K9 for each
batch.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch


def sliding_windows(signal: np.ndarray, window_size: int, stride: int):
    """[T, C] -> iterator of [window_size, C] views, ``stride`` apart; the
    last partial window is dropped (reference:brainformer.py:586)."""
    t = signal.shape[0]
    n_iters = int((t - window_size) // stride)
    for i in range(max(n_iters, 0) + 1):
        start = i * stride
        yield signal[start:start + window_size]


@torch.no_grad()
def stream_predict(model, signal: np.ndarray, *, window_size: int,
                   stride: int = 8, batch_windows: int = 8,
                   method: Optional[Callable] = None) -> List[torch.Tensor]:
    """``method`` (``model.encode`` by default) over every sliding window
    of ``signal`` [T, C], ``batch_windows`` windows a call, on the model's
    device. Returns the per-window outputs, in window order."""
    method = method or model.encode
    windows = list(sliding_windows(signal, window_size, stride))
    if not windows:
        return []
    device = next(model.parameters()).device
    outs = []
    for s in range(0, len(windows), batch_windows):
        chunk = windows[s:s + batch_windows]
        pad = batch_windows - len(chunk)      # one shape for every call
        x = np.stack(chunk + [chunk[-1]] * pad).astype(np.float32)
        y = method(torch.from_numpy(x).to(device))
        outs.extend(y[i] for i in range(len(chunk)))
    return outs
