"""Kernel K3's plain twin (``ops/cuda/beam_reorder.py``) against the JAX
package's Pallas ``beam_reorder`` in interpret mode, and the port's
``GPT.reorder_cache`` against the JAX package's, for float and int8
(``QuantCache``) caches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.models import gpt2 as jgpt2
from frankenstein_tpu.ops.pallas import beam_reorder as jbr
from frankenstein_tpu_torch.models import gpt2
from frankenstein_tpu_torch.ops.cuda import beam_reorder as tbr

torch.set_num_threads(1)


def _cache(rng, shape, dtype):
    if dtype == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32)


# the cases of tests/test_decode.py::test_beam_reorder_kernel_matches_take
CASES = [(5, 40, jnp.bfloat16, torch.bfloat16),
         (4, 16, jnp.float32, torch.float32),
         (5, 40, jnp.int8, torch.int8)]


@pytest.mark.parametrize("w,bw,jdt,tdt", CASES)
def test_twin_matches_pallas_interpret(w, bw, jdt, tdt):
    """Bitwise equal to the Pallas kernel, and to ``jnp.take`` on axis 1."""
    rng = np.random.default_rng(0)
    n_layer, s, e = 2, 16, 128
    raw = _cache(rng, (n_layer, bw, s, e),
                 "int8" if tdt == torch.int8 else "float")
    parent = rng.integers(0, w, (bw,)).astype(np.int32)
    jcache = jnp.asarray(raw, jdt)
    want = np.asarray(jbr.beam_reorder(jcache, jnp.asarray(parent), w=w,
                                       interpret=True))
    flat = (np.arange(bw) // w) * w + parent
    np.testing.assert_array_equal(
        want, np.asarray(jnp.take(jcache, jnp.asarray(flat), axis=1)))
    tcache = torch.from_numpy(raw).to(tdt)
    got = tbr.beam_reorder_ref(tcache, torch.from_numpy(parent), w=w)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_wrapper_reorders_in_place_on_cpu_uncounted():
    rng = np.random.default_rng(1)
    w, bw = 3, 12
    k = torch.from_numpy(_cache(rng, (2, bw, 8, 128), "int8"))
    v = torch.from_numpy(_cache(rng, (2, bw, 8, 128), "int8"))
    parent = torch.from_numpy(rng.integers(0, w, (bw,)).astype(np.int32))
    want_k = tbr.beam_reorder_ref(k, parent, w=w)
    want_v = tbr.beam_reorder_ref(v, parent, w=w)
    before = tbr.launches
    k_out, v_out = tbr.beam_reorder(k, v, parent, w=w)
    assert k_out is k and v_out is v
    assert torch.equal(k, want_k) and torch.equal(v, want_v)
    assert tbr.launches == before


@pytest.mark.parametrize("group", [0, 3])
def test_reorder_cache_matches_jax(group):
    """``GPT.reorder_cache`` gathers the codes as the JAX package does, with
    or without the group hint, and never touches a QuantCache's scales."""
    rng = np.random.default_rng(2)
    w, b = 3, 4
    bw = b * w
    k = _cache(rng, (2, bw, 16, 32), "int8")
    v = _cache(rng, (2, bw, 16, 32), "int8")
    ks, vs = (rng.random((2, 1, 32)).astype(np.float32) for _ in range(2))
    flat = ((np.arange(bw) // w) * w
            + rng.integers(0, w, (bw,))).astype(np.int32)
    jq = jgpt2.QuantCache(*(jnp.asarray(a) for a in (k, v, ks, vs)))
    want = jgpt2.GPT.reorder_cache(jq, jnp.asarray(flat), group=group)
    tq = gpt2.QuantCache(*(torch.from_numpy(a.copy()) for a in (k, v, ks,
                                                                vs)))
    got = gpt2.GPT.reorder_cache(tq, torch.from_numpy(flat).long(),
                                 group=group)
    assert isinstance(got, gpt2.QuantCache)
    assert got.k_scale is tq.k_scale and got.v_scale is tq.v_scale
    for g, jw in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(jw))


def test_reorder_cache_float_tuple_matches_index_select():
    rng = np.random.default_rng(3)
    cache = tuple(torch.from_numpy(_cache(rng, (2, 8, 4, 16), "float"))
                  for _ in range(2))
    flat = torch.tensor([1, 1, 0, 3, 2, 2, 3, 3])
    want = tuple(c.index_select(1, flat) for c in cache)
    got = gpt2.GPT.reorder_cache(cache, flat)
    assert isinstance(got, tuple) and not isinstance(got, gpt2.QuantCache)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    local = torch.tensor([1, 1, 3, 2, 4, 4, 7, 6])     # groups of 2
    grouped = gpt2.GPT.reorder_cache(tuple(c.clone() for c in cache), local,
                                     group=2)
    for g, c in zip(grouped, cache):
        assert torch.equal(g, c.index_select(1, local))
