"""Signal preprocessing on the device (``frankenstein_tpu/ops/preprocess.py``).

Torch functions on the caller's tensors, where they lie: z-scores (whole and
per block), the Gaussian smoothing of ``scipy.ndimage.gaussian_filter1d``,
the FFT resample of ``scipy.signal.resample`` and an SVD PCA. The whisper
prep (``data/whisper_prep.py``) runs the PCA and the resample.

An SVD fixes each singular vector only up to its sign, and LAPACK on the CPU
and cuSOLVER on the card may choose differently: ``pca_fit``'s components
agree with the JAX package's up to one sign per component. No sign
convention is added; the JAX package has none.
"""

from __future__ import annotations

import torch


def zscore(x: torch.Tensor, dim=0, eps: float = 0.0) -> torch.Tensor:
    """StandardScaler semantics: ddof 0, a zero-std column left unscaled
    (its std taken as 1)."""
    mean = torch.mean(x, dim=dim, keepdim=True)
    std = torch.std(x, dim=dim, keepdim=True, correction=0)
    std = torch.where(std == 0, torch.ones_like(std), std)
    return (x - mean) / (std + eps)


def zscore_by_segments(x: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Per-block z-score over concatenated trials: x [N, C] rows,
    ``segment_ids`` [N] the block of each row; each block is normalised by
    its own mean and std (segment sums, as the JAX package takes them)."""
    seg = segment_ids.long()
    sums = lambda v: torch.zeros((num_segments,) + v.shape[1:], dtype=v.dtype,
                                 device=v.device).index_add_(0, seg, v)
    cnt = torch.clamp(sums(torch.ones((x.shape[0], 1), dtype=x.dtype,
                                      device=x.device)), min=1.0)
    mean = sums(x) / cnt
    var = torch.clamp(sums(x * x) / cnt - mean * mean, min=0.0)
    std = torch.sqrt(var)
    std = torch.where(std == 0, torch.ones_like(std), std)
    return (x - mean[seg]) / std[seg]


def gaussian_kernel1d(sigma: float, truncate: float = 4.0,
                      device=None) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter1d``'s kernel, f32."""
    radius = int(truncate * sigma + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _symmetric_index(t: int, r: int, device) -> torch.Tensor:
    """Source rows of numpy's "symmetric" padding by r on each side (the
    edge sample repeated, any r)."""
    i = torch.arange(-r, t + r, device=device) % (2 * t)
    return torch.where(i < t, i, 2 * t - 1 - i)


def gaussian_smooth(x: torch.Tensor, sigma: float = 1.0,
                    truncate: float = 4.0) -> torch.Tensor:
    """Gaussian smoothing along time (dim 0 of [T, C], dim 1 of [B, T, C])
    with scipy's default "reflect" boundary (numpy's "symmetric")."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    b, t, c = x.shape
    k = gaussian_kernel1d(sigma, truncate, device=x.device).to(x.dtype)
    r = (k.shape[0] - 1) // 2
    xp = x[:, _symmetric_index(t, r, x.device)]              # [B, T + 2r, C]
    out = torch.nn.functional.conv1d(
        xp.permute(0, 2, 1).reshape(b * c, 1, t + 2 * r), k.reshape(1, 1, -1))
    out = out.reshape(b, c, t).permute(0, 2, 1)
    return out[0] if squeeze else out


def resample_fft(x: torch.Tensor, num: int, dim: int = 0) -> torch.Tensor:
    """FFT resample to ``num`` samples along ``dim``, as
    ``scipy.signal.resample`` does for real input."""
    n = x.shape[dim]
    spec = torch.fft.rfft(x, dim=dim)
    keep = min(num, n) // 2 + 1
    shape = list(x.shape)
    shape[dim] = num // 2 + 1
    out = torch.zeros(shape, dtype=spec.dtype, device=x.device)
    out.narrow(dim, 0, keep).copy_(spec.narrow(dim, 0, keep))
    m = min(num, n)
    if m % 2 == 0 and num != n:
        # downsampling folds the negative-frequency half into the Nyquist
        # bin; upsampling splits it
        out.narrow(dim, m // 2, 1).mul_(2.0 if num < n else 0.5)
    return torch.fft.irfft(out, n=num, dim=dim) * (num / n)


def pca_fit(x: torch.Tensor, n_components: int):
    """SVD PCA over [N, C] rows -> (mean [C], components [n_components, C]);
    each component is fixed only up to its sign."""
    mean = torch.mean(x, dim=0)
    _, _, vt = torch.linalg.svd(x - mean, full_matrices=False)
    return mean, vt[:n_components]


def pca_transform(x: torch.Tensor, mean: torch.Tensor,
                  components: torch.Tensor) -> torch.Tensor:
    return (x - mean) @ components.T
