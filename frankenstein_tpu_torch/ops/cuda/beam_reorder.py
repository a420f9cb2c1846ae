"""K3: beam-search KV-cache reorder, in place.

Replaces ``frankenstein_tpu/ops/pallas/beam_reorder.py:beam_reorder``. Beam
parents never leave their sentence's group of ``w`` rows, so row
``g*w + n`` of each ``[L, B*W, S, E]`` cache side becomes row
``g*w + parent_local[g*w + n]``. The kernel is CUDA C++ in
``frankenstein_tpu_torch/csrc/beam_reorder.cu``; its source note says what
bounds it on an H100 and how it runs in place.

``beam_reorder`` launches the kernel for CUDA tensors (one launch for both
sides) and runs the plain PyTorch twin ``beam_reorder_ref`` for CPU
tensors, never one in place of the other.
"""

from __future__ import annotations

import torch

from frankenstein_tpu_torch.ops.cuda import build

launches = 0   # wrapper calls that ran the CUDA kernel (both sides at once)

MAX_W = 16     # beams per group the kernel stages (csrc/beam_reorder.cu)


def beam_reorder_ref(cache_side, parent_local, *, w: int):
    """Plain twin: ``index_select`` on the beam axis with the flat parents
    ``(row // w) * w + parent_local``. Returns a new tensor."""
    bw = cache_side.shape[1]
    rows = torch.arange(bw, device=cache_side.device)
    flat = (rows // w) * w + parent_local.to(cache_side.device).long()
    return torch.index_select(cache_side, 1, flat)


def _check(k_cache, v_cache, parent, w: int) -> None:
    n_layer, bw = k_cache.shape[:2]
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (c.shape != k_cache.shape or c.dtype != k_cache.dtype
                or not c.is_contiguous() or c.device != k_cache.device):
            raise ValueError(f"{name}: need a contiguous tensor like k_cache "
                             f"{tuple(k_cache.shape)} {k_cache.dtype}")
    row_bytes = k_cache[0, 0].numel() * k_cache.element_size()
    if not 1 <= w <= MAX_W or bw % w or row_bytes % 16:
        raise ValueError(f"w={w}, B*W={bw}, row bytes {row_bytes}: the "
                         f"kernel needs 1 <= w <= {MAX_W}, w | B*W and rows "
                         "of a multiple of 16 bytes")
    if n_layer * (bw // w) > 65535:
        raise ValueError(f"{n_layer} layers x {bw // w} groups exceed the "
                         "kernel's grid")
    if parent.shape != (bw,):
        raise ValueError(f"parent_local: need [{bw}], got "
                         f"{tuple(parent.shape)}")


def beam_reorder(k_cache, v_cache, parent_local, *, w: int):
    """Reorder both cache sides [L, B*W, S, E] IN PLACE within each group of
    ``w`` rows: ``out[g*w + n] = in[g*w + parent_local[g*w + n]]`` with
    ``parent_local`` [B*W] in [0, w). Any dtype. Returns (k_cache, v_cache),
    the same tensors."""
    global launches
    if not k_cache.is_cuda:
        for c in (k_cache, v_cache):
            c.copy_(beam_reorder_ref(c, parent_local, w=w))
        return k_cache, v_cache
    parent = parent_local.to(device=k_cache.device,
                             dtype=torch.int32).contiguous()
    _check(k_cache, v_cache, parent, w)
    n_layer, bw = k_cache.shape[:2]
    rc = build.library().fk_beam_reorder(
        k_cache.data_ptr(), v_cache.data_ptr(), parent.data_ptr(), n_layer,
        bw // w, w, k_cache[0, 0].numel() * k_cache.element_size(),
        torch.cuda.current_stream(k_cache.device).cuda_stream)
    build.check(rc, "beam_reorder")
    launches += 1
    return k_cache, v_cache
