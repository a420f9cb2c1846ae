"""The port's plain ops against the JAX package's, on the same seeded
inputs (float32 on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.ops import attention as jattn
from frankenstein_tpu.ops import masks as jmasks
from frankenstein_tpu.ops import norms as jnorms
from frankenstein_tpu.ops import rope as jrope
from frankenstein_tpu_torch.ops import attention as tattn
from frankenstein_tpu_torch.ops import masks as tmasks
from frankenstein_tpu_torch.ops import norms as tnorms
from frankenstein_tpu_torch.ops import rope as trope

torch.set_num_threads(1)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("t,p", [(24, 8), (30, 7), (16, 16)])
def test_block_causal_mask_exact(t, p):
    np.testing.assert_array_equal(
        tmasks.block_causal_mask(t, p).numpy(),
        np.asarray(jmasks.block_causal_mask(t, p)))


@pytest.mark.parametrize("tq,tk", [(5, 5), (3, 9), (1, 12)])
def test_causal_mask_exact(tq, tk):
    np.testing.assert_array_equal(tmasks.causal_mask(tq, tk).numpy(),
                                  np.asarray(jmasks.causal_mask(tq, tk)))


def test_build_rope_cache():
    np.testing.assert_allclose(
        trope.build_rope_cache(32, 96, 10000.0).numpy(),
        np.asarray(jrope.build_rope_cache(32, 96, 10000.0)), atol=1e-6)


def test_rope_for_positions():
    rng = np.random.default_rng(2)
    cache = jrope.build_rope_cache(16, 40)
    pos = rng.integers(0, 40, size=(3, 7))
    np.testing.assert_array_equal(
        trope.rope_for_positions(torch.tensor(np.asarray(cache)),
                                 torch.from_numpy(pos)).numpy(),
        np.asarray(jrope.rope_for_positions(cache, jnp.asarray(pos))))


@pytest.mark.parametrize("align", ["suffix", "prefix"])
def test_apply_rope(align):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 12, 3, 16)
    cache = jrope.build_rope_cache(16, 20)
    want = jrope.apply_rope(jnp.asarray(x), cache, align=align)
    got = trope.apply_rope(torch.from_numpy(x),
                           torch.tensor(np.asarray(cache)), align=align)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("align", ["suffix", "prefix"])
def test_apply_rope_folded(align):
    rng = np.random.default_rng(1)
    h, d = 3, 16
    x = _rand(rng, 2, 12, h * d)
    cache = jrope.build_rope_cache(d, 20)
    jcos, jsin = jrope.folded_tables(cache, h)
    tcos, tsin = trope.folded_tables(torch.tensor(np.asarray(cache)), h)
    np.testing.assert_array_equal(tcos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(tsin.numpy(), np.asarray(jsin))
    want = jrope.apply_rope_folded(jnp.asarray(x), jcos, jsin, align=align)
    got = trope.apply_rope_folded(torch.from_numpy(x), tcos, tsin,
                                  align=align)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm(bias):
    rng = np.random.default_rng(2)
    x, w, b = _rand(rng, 3, 5, 24), _rand(rng, 24), _rand(rng, 24)
    want = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(b) if bias else None)
    got = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b) if bias else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_rms_norm():
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 3, 5, 24), _rand(rng, 24)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w))
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("mode,tq,p", [(None, 16, 0), ("causal", 16, 0),
                                       ("causal", 6, 0), ("slab", 16, 4),
                                       ("slab", 10, 4)])
def test_dot_product_attention(mode, tq, p):
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 2, tq, 3, 8), _rand(rng, 2, 16, 3, 8), \
        _rand(rng, 2, 16, 3, 8)
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask_mode=mode,
        tok_per_time=p, impl="xla")
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask_mode=mode, tok_per_time=p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("t,length", [(1, 5), (4, 0), (3, 9)])
def test_cached_attention(t, length):
    rng = np.random.default_rng(5)
    q = _rand(rng, 2, t, 4, 8)
    kc, vc = _rand(rng, 2, 16, 4, 8), _rand(rng, 2, 16, 4, 8)
    want = jattn.cached_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.int32(length + 1))
    got = tattn.cached_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), length + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
