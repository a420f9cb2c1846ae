"""ctypes bindings for the native host-preprocessing library
(native/preprocess.cpp). Falls back to the numpy implementations in
data/datasets.py when the shared library hasn't been built.

Build once: ``make -C native``.

A copy of ``frankenstein_tpu/data/native.py`` (framework-free; the port may
not import the JAX package).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_LIB_PATHS = [
    Path(__file__).resolve().parents[2] / "native" / "libfkpreproc.so",
    Path("native/libfkpreproc.so"),
]


@functools.lru_cache()
def _load() -> Optional[ctypes.CDLL]:
    for p in _LIB_PATHS:
        if p.exists():
            lib = ctypes.CDLL(str(p))
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.zscore_by_blocks.argtypes = [
                f32p, i32p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, f32p]
            lib.gaussian_smooth.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, f32p]
            lib.pad_truncate.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f32p]
            return lib
    return None


def available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def z_score_per_block_scaling(brain_list: Sequence[np.ndarray],
                              idx_list: Sequence[int]) -> List[np.ndarray]:
    """Native per-block z-score; numpy fallback if unbuilt."""
    lib = _load()
    if lib is None:
        from frankenstein_tpu_torch.data import datasets
        return datasets.z_score_per_block_scaling(brain_list, idx_list)

    blocks = sorted({int(b) for b in idx_list})
    remap = {b: i for i, b in enumerate(blocks)}
    lens = [len(b) for b in brain_list]
    cat = np.ascontiguousarray(np.concatenate(brain_list, axis=0),
                               dtype=np.float32)
    row_block = np.repeat(
        np.asarray([remap[int(b)] for b in idx_list], np.int32), lens)
    out = np.empty_like(cat)
    lib.zscore_by_blocks(
        _f32p(cat), row_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cat.shape[0], cat.shape[1], len(blocks), _f32p(out))
    res, s = [], 0
    for n in lens:
        res.append(out[s:s + n].copy())
        s += n
    return res


def gaussian_smooth(x: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    lib = _load()
    if lib is None:
        from scipy.ndimage import gaussian_filter1d
        return gaussian_filter1d(x, sigma=sigma, axis=0).astype(np.float32)
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(x)
    lib.gaussian_smooth(_f32p(x), x.shape[0], x.shape[1],
                        ctypes.c_float(sigma), _f32p(out))
    return out


def pad_truncate(x: np.ndarray, max_len: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        from frankenstein_tpu_torch.data.datasets import (
            pad_truncate_brain_list)
        return pad_truncate_brain_list([x], max_len)[0]
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty((max_len, x.shape[1]), np.float32)
    lib.pad_truncate(_f32p(x), x.shape[0], x.shape[1], max_len, _f32p(out))
    return out
