"""The port's sliding-window inference (``decode/streaming.py``) against the
JAX package's on the CPU: the windows, and ``stream_predict`` over a tiny
Franky with ``export_franky`` weights (its encode, the default method) and
over a SoundStream's encoder (a method given), with the last batch padded.
float32; inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.decode import streaming as jstreaming
from frankenstein_tpu.models import vq_brain as jvq_brain
from frankenstein_tpu.models.franky import Franky as JFranky
from frankenstein_tpu.models.import_reference import (export_franky,
                                                      export_soundstream)
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.decode import streaming
from frankenstein_tpu_torch.models.franky import Franky
from frankenstein_tpu_torch.models.vq_brain import SoundStream
from frankenstein_tpu_torch.models.weights import load_strict
from tests.test_torch_franky import tiny_cfg

torch.set_num_threads(1)

TOL = 1e-4     # the Franky slice's encode tolerance (f32 both sides)


@pytest.mark.parametrize("t,window,stride", [(80, 32, 8), (32, 32, 8),
                                             (20, 32, 8), (100, 16, 7)])
def test_sliding_windows_match_jax(t, window, stride):
    signal = np.arange(t * 3, dtype=np.float32).reshape(t, 3)
    want = list(jstreaming.sliding_windows(signal, window, stride))
    got = list(streaming.sliding_windows(signal, window, stride))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def franky_pair():
    rng = np.random.default_rng(0)
    jmodel = JFranky(tiny_cfg(jconfig))
    x = rng.standard_normal((1, 32, 8)).astype(np.float32)
    y = rng.integers(0, 512, (1, 8)).astype(np.int32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    model = load_strict(Franky(tiny_cfg(tconfig)), export_franky(params))
    return jmodel, params, model


@pytest.mark.parametrize("batch_windows", [3, 8])
def test_stream_predict_franky_matches_jax(franky_pair, batch_windows):
    """7 windows of a [80, 8] recording, Franky's encode by default: 3
    calls of 3 (the last padded) or one call of 8."""
    jmodel, params, model = franky_pair
    signal = np.random.default_rng(1).standard_normal((80, 8)).astype(
        np.float32)
    want = jstreaming.stream_predict(jmodel, params, signal, window_size=32,
                                     stride=8, batch_windows=batch_windows)
    calls = []
    encode = model.encode

    def counted(x):
        calls.append(tuple(x.shape))
        return encode(x)

    model.encode = counted
    try:
        got = streaming.stream_predict(model, signal, window_size=32,
                                       stride=8, batch_windows=batch_windows)
    finally:
        del model.encode
    assert len(got) == len(want) == 7
    assert calls == [(batch_windows, 32, 8)] * -(-7 // batch_windows)
    for a, b in zip(got, want):
        assert a.shape == (4, 128)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


def test_stream_predict_a_given_method_matches_jax():
    cfg = dict(n_electrodes=6, C=8, D=4, codebook_size=16)
    jmodel = jvq_brain.SoundStream(jconfig.VQVAEConfig(**cfg))
    signal = np.random.default_rng(2).standard_normal((40, 6)).astype(
        np.float32)
    v = jmodel.init({"params": jax.random.key(0), "vq": jax.random.key(1)},
                    jnp.asarray(signal[None, :16]), train=False)
    model = load_strict(SoundStream(tconfig.VQVAEConfig(**cfg)),
                        export_soundstream(v))
    want = jstreaming.stream_predict(jmodel, v, signal, window_size=16,
                                     stride=4, batch_windows=4,
                                     method=lambda m, x: m.encoder(x))
    got = streaming.stream_predict(model, signal, window_size=16, stride=4,
                                   batch_windows=4, method=model.encoder)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_stream_predict_runs_without_autograd(franky_pair):
    _, _, model = franky_pair
    signal = np.zeros((40, 8), np.float32)
    outs = streaming.stream_predict(model, signal, window_size=32)
    assert len(outs) == 2 and not outs[0].requires_grad
