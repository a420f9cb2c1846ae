"""The port's ``analysis.py`` against the JAX package's on the CPU: the
dataset statistics, PCA up to one sign per component (scikit-learn's ICA,
NMF and Isomap where it is installed), and the GPT crops on the port's
state dict (``transformer.h.{i}.*``, ``transformer.wpe.weight``), each
equal to the JAX crop written out by ``export_gpt``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import analysis as janalysis
from frankenstein_tpu import config as jconfig
from frankenstein_tpu.models import gpt2 as jgpt2
from frankenstein_tpu.models.import_reference import export_gpt
from frankenstein_tpu_torch import analysis
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.models.gpt2 import GPT
from frankenstein_tpu_torch.models.weights import load_strict

PCA_TOL = 1e-4     # f32 SVDs by two libraries


def _trials(seed=0):
    rng = np.random.default_rng(seed)
    brains = [rng.standard_normal((int(t), 4)) for t in
              rng.integers(300, 920, 12)]
    tokens = [list(range(int(n))) for n in rng.integers(3, 25, 12)]
    return brains, tokens


def test_dataset_stats_match_jax():
    brains, tokens = _trials()
    assert analysis.dataset_stats(brains, tokens) == \
        janalysis.dataset_stats(brains, tokens)
    assert analysis.dataset_stats(brains) == janalysis.dataset_stats(brains)
    assert analysis.dataset_stats([]) == janalysis.dataset_stats([])


def test_find_long_samples_matches_jax():
    brains, _ = _trials(1)
    for limit in (0, 500, 768, 2000):
        assert analysis.find_long_samples(brains, limit) == \
            janalysis.find_long_samples(brains, limit)


@pytest.mark.parametrize("n_components", [1, 3, 5])
def test_pca_matches_jax_up_to_sign(n_components):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((200, 8)) @ rng.standard_normal((8, 8))
         ).astype(np.float32)
    want = np.asarray(janalysis.reduce_dimensionality(x, n_components))
    got = analysis.reduce_dimensionality(x, n_components)
    assert got.shape == want.shape == (200, n_components)
    for c in range(n_components):
        sign = np.sign(np.dot(got[:, c], want[:, c]))
        np.testing.assert_allclose(sign * got[:, c], want[:, c],
                                   atol=PCA_TOL * np.abs(want).max())


@pytest.mark.parametrize("method", ["ica", "nmf", "isomap"])
def test_host_methods_through_scikit_learn(method):
    pytest.importorskip("sklearn")
    x = np.random.default_rng(3).standard_normal((60, 6))
    assert analysis.reduce_dimensionality(x, 2, method).shape == (60, 2)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown method"):
        analysis.reduce_dimensionality(np.zeros((4, 2)), 1, "tsne")


def _gpt_params(n_layer=3, block_size=16):
    cfg = jconfig.GPTConfig(block_size=block_size, vocab_size=64,
                            n_layer=n_layer, n_head=2, n_embd=16)
    params = jgpt2.GPT(cfg).init(jax.random.key(0),
                                 jnp.zeros((1, 4), jnp.int32))
    return cfg, params


@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_crop_gpt_layers_matches_jax(n_layers):
    cfg, params = _gpt_params()
    want = export_gpt(janalysis.crop_gpt_layers(params, n_layers))
    got = analysis.crop_gpt_layers(export_gpt(params), n_layers)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    load_strict(GPT(tconfig.GPTConfig(**{**cfg.to_dict(),
                                         "n_layer": n_layers})), got)


def test_crop_block_size_matches_jax():
    cfg, params = _gpt_params()
    want_params, want_cfg = janalysis.crop_block_size(params, cfg, 8)
    got, got_cfg = analysis.crop_block_size(
        export_gpt(params), tconfig.GPTConfig(**cfg.to_dict()), 8)
    assert got_cfg.to_dict() == want_cfg.to_dict()
    want = export_gpt(want_params)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = load_strict(GPT(got_cfg), got)
    assert model.transformer.wpe.weight.shape == (8, 16)
    with pytest.raises(AssertionError):
        analysis.crop_block_size(got, got_cfg, 9)


def test_crops_work_on_a_port_state_dict():
    model = GPT(tconfig.GPTConfig(block_size=16, vocab_size=64, n_layer=3,
                                  n_head=2, n_embd=16))
    sd = analysis.crop_gpt_layers(model.state_dict(), 1)
    assert not any(k.startswith(("transformer.h.1.", "transformer.h.2."))
                   for k in sd)
    small = GPT(tconfig.GPTConfig(block_size=16, vocab_size=64, n_layer=1,
                                  n_head=2, n_embd=16))
    small.load_state_dict(sd)
    assert torch.equal(small.transformer.h[0].ln_1.weight,
                       model.transformer.h[0].ln_1.weight)
