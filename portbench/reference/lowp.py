"""The controls' arithmetic: the reference computed one step below the
precision the configuration states, the step a later change might be
tempted to take.

- bfloat16 operands (activations and weights of every product, the
  attention's scores and probabilities) round to float8 e4m3 with a
  per-tensor scale, as fp8 training and serving do; in a backward pass the
  gradient reaching them rounds to float8 e5m2;
- int8 weights (the w8a16 decode weights) round to int4 with a scale per
  output lane; an int8 KV cache rounds to int4 with a scale per lane.
"""

from __future__ import annotations

import torch

from portbench.reference.blocks import Numerics

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


def int4_rows(w: torch.Tensor, dim: int) -> torch.Tensor:
    """Symmetric int4 (codes -7..7) with one scale per slice along every
    dimension but ``dim``, which the scale's absmax runs over; gradients
    pass straight through."""
    scale = w.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 7
    q = torch.clamp(torch.round(w / scale), -7, 7) * scale
    return w + (q - w).detach()


class LowPrecision(Numerics):
    """fp8 for the stated bfloat16; int4 for the stated int8 weights (those
    for which ``int8_weight(name)`` holds) and, with ``int8_kv``, the
    cache."""

    def __init__(self, int8_weight=lambda name: False, int8_kv: bool = False):
        self.int8_weight = int8_weight
        self.int8_kv = int8_kv

    def act(self, x):
        return _Fp8.apply(x)

    def weight(self, name, w):
        if self.int8_weight(name):
            return int4_rows(w, dim=-1)
        return _Fp8.apply(w)

    def kv(self, x):
        if not self.int8_kv:
            return x
        lanes = x.reshape(x.shape[0] * x.shape[1], -1)
        return int4_rows(lanes, dim=0).reshape(x.shape)
