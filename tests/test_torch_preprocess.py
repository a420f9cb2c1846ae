"""The port's device preprocessing (``ops/preprocess.py``) and the whisper
prep (``data/whisper_prep.py``) against the JAX package's and scipy's, on
the CPU, f32 inputs from numpy seeds.

An SVD fixes each singular vector only up to its sign, and the two
packages' LAPACK calls may choose differently: PCA components are compared
up to one sign per component (each port component is first flipped to the
sign of the JAX package's, then compared), and so are the whisper prep's
outputs, whose rows are the components' projections."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import scipy.signal
import torch

from frankenstein_tpu.data import whisper_prep as jprep
from frankenstein_tpu.ops import preprocess as jpre
from frankenstein_tpu_torch.data import whisper_prep as tprep
from frankenstein_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(1)

TOL = 1e-5        # f32 on both sides, other summation orders
FFT_TOL = 1e-4    # f32 FFTs against scipy's float64 resample, unit signals


def _x(shape, seed=0, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _sign_aligned(got, want):
    """``got``'s rows, each flipped to the sign of its dot with ``want``'s
    (the one sign an SVD leaves free per component)."""
    signs = np.sign(np.sum(got * want, axis=1, keepdims=True))
    return got * signs


@pytest.mark.parametrize("dim", [0, 1])
def test_zscore_matches_jax(dim):
    x = _x((40, 6), seed=1, scale=3.0, shift=2.0)
    x[:, 2] = 5.0                        # a zero-std column stays unscaled
    want = np.asarray(jpre.zscore(jnp.asarray(x), axis=dim))
    got = tpre.zscore(torch.from_numpy(x), dim=dim).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_zscore_by_segments_matches_jax():
    x = _x((50, 5), seed=2, scale=2.0, shift=1.0)
    seg = np.random.default_rng(3).integers(0, 4, 50).astype(np.int32)
    x[seg == 1, 3] = 7.0                 # zero std inside one block
    want = np.asarray(jpre.zscore_by_segments(jnp.asarray(x),
                                              jnp.asarray(seg), 5))
    got = tpre.zscore_by_segments(torch.from_numpy(x), torch.from_numpy(seg),
                                  5).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("sigma", [0.7, 1.0, 2.5])
def test_gaussian_kernel_matches_jax(sigma):
    np.testing.assert_allclose(tpre.gaussian_kernel1d(sigma).numpy(),
                               np.asarray(jpre.gaussian_kernel1d(sigma)),
                               atol=1e-7)


@pytest.mark.parametrize("shape,sigma", [((30, 4), 1.0), ((2, 25, 3), 2.0),
                                         ((5, 2), 3.0)])
def test_gaussian_smooth_matches_jax_and_scipy(shape, sigma):
    """(5, 2) at sigma 3: a pad of 12 rows over 5, the symmetric padding
    repeated."""
    x = _x(shape, seed=4)
    got = tpre.gaussian_smooth(torch.from_numpy(x), sigma=sigma).numpy()
    want = np.asarray(jpre.gaussian_smooth(jnp.asarray(x), sigma=sigma))
    np.testing.assert_allclose(got, want, atol=TOL)
    ref = scipy.ndimage.gaussian_filter1d(x.astype(np.float64), sigma,
                                          axis=x.ndim - 2)
    np.testing.assert_allclose(got, ref, atol=TOL)


@pytest.mark.parametrize("n,num,dim", [(50, 100, 0), (51, 102, 0),
                                       (64, 40, 1), (63, 80, 1), (30, 30, 0)])
def test_resample_fft_matches_jax_and_scipy(n, num, dim):
    """Up and down, even and odd lengths, along either axis."""
    x = _x((n, 3) if dim == 0 else (3, n), seed=5)
    got = tpre.resample_fft(torch.from_numpy(x), num, dim=dim).numpy()
    want = np.asarray(jpre.resample_fft(jnp.asarray(x), num, axis=dim))
    np.testing.assert_allclose(got, want, atol=FFT_TOL)
    ref = scipy.signal.resample(x.astype(np.float64), num, axis=dim)
    np.testing.assert_allclose(got, ref, atol=FFT_TOL)


def test_pca_matches_jax_up_to_sign():
    x = _x((300, 12), seed=6) @ _x((12, 12), seed=7) + 0.5
    mean, comps = tpre.pca_fit(torch.from_numpy(x), 5)
    jmean, jcomps = jpre.pca_fit(jnp.asarray(x), 5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=TOL)
    aligned = _sign_aligned(comps.numpy(), np.asarray(jcomps))
    np.testing.assert_allclose(aligned, np.asarray(jcomps), atol=1e-4)
    z = tpre.pca_transform(torch.from_numpy(x), mean, comps).numpy()
    jz = np.asarray(jpre.pca_transform(jnp.asarray(x), jmean, jcomps))
    np.testing.assert_allclose(_sign_aligned(z.T, jz.T).T, jz, atol=1e-3)


def _brains(seed=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, 300)).astype(np.float32)
            for t in (100, 200, 37)]


def test_whisper_prep_geometry():
    """A trial of T steps fills 2T frames (up to the pad length), the rest
    zero; every component of the 256 voltage channels comes back."""
    brains = _brains()
    mean, comps = tprep.fit_pca(brains, n_voltage_ch=256, device="cpu")
    assert mean.shape == (256,) and comps.shape == (256, 256)
    arr = tprep.prepare_brain_data_for_whisper(
        brains, mean, comps, n_components=16, pad_length=300, device="cpu")
    assert arr.shape == (3, 16, 300) and arr.dtype == np.float32
    for i, t in enumerate((100, 200, 37)):
        n = min(2 * t, 300)
        assert np.abs(arr[i, :, :n]).sum() > 0
        assert np.abs(arr[i, :, n:]).sum() == 0


def test_whisper_prep_matches_jax_up_to_sign():
    """The prep's values against the JAX package's: the PCA fit up to sign,
    then each output row (a component's projection, resampled) up to the
    same sign."""
    brains = _brains(9)
    mean, comps = tprep.fit_pca(brains, device="cpu")
    jmean, jcomps = jprep.fit_pca(brains)
    np.testing.assert_allclose(mean, jmean, atol=TOL)
    signs = np.sign(np.sum(comps * jcomps, axis=1))
    np.testing.assert_allclose(comps[:16] * signs[:16, None], jcomps[:16],
                               atol=1e-4)
    got = tprep.prepare_brain_data_for_whisper(
        brains, mean, comps, n_components=16, pad_length=300, device="cpu")
    want = jprep.prepare_brain_data_for_whisper(
        brains, jmean, jcomps, n_components=16, pad_length=300)
    np.testing.assert_allclose(got * signs[None, :16, None], want,
                               atol=1e-3)
