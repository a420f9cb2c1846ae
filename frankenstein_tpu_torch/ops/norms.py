"""Normalization functions (``frankenstein_tpu/ops/norms.py``).

Both normalise in float32, cast to ``x.dtype``, and only then apply
``* weight (+ bias)`` — the JAX package's rounding point. ``F.layer_norm``
applies the affine step before rounding, so it is not used.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias=None,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * weight
    if bias is not None:
        out = out + bias
    return out
