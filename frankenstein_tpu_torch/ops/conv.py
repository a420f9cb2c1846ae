"""Causal 1-D convolutions over [B, T, C] (``frankenstein_tpu/ops/conv.py``).

- ``CausalConv1d``: left-pad dilation * (k - 1) so output[t] sees inputs
  <= t; weight [out, in, k], torch's ``nn.Conv1d`` layout.
- ``CausalConvTranspose1d``: torch's transposed conv (weight [in, out, k]),
  then trim (k - 1) + 1 - stride trailing frames (the reference's
  ``causal_padding``), so length maps T -> T * stride causally. The JAX
  package stores this kernel flipped along its width
  (``models/import_reference.py:_conv_transpose``) and its exporter flips
  it back, so the port computes torch's own transposed conv.

Inputs and outputs are [B, T, C], as in the JAX package; each module
transposes around torch's [B, C, T] convolution. ``dtype`` is the compute
dtype (``models/layers.py``): input, weight and bias are cast to it, the
parameters' own dtype when None.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class CausalConv1d(nn.Conv1d):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, dilation=dilation, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype or self.weight.dtype
        pad = self.dilation[0] * (self.kernel_size[0] - 1)
        h = F.pad(x.to(cdt).transpose(1, 2), (pad, 0))
        y = F.conv1d(h, self.weight.to(cdt), self.bias.to(cdt),
                     stride=self.stride, dilation=self.dilation)
        return y.transpose(1, 2)


class CausalConvTranspose1d(nn.ConvTranspose1d):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype or self.weight.dtype
        y = F.conv_transpose1d(x.to(cdt).transpose(1, 2),
                               self.weight.to(cdt), self.bias.to(cdt),
                               stride=self.stride)
        trim = (self.kernel_size[0] - 1) + 1 - self.stride[0]
        if trim > 0:
            y = y[..., :-trim]
        return y.transpose(1, 2)
