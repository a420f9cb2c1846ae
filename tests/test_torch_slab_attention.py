"""Kernel K1's plain twin (``ops/cuda/slab_attention.py``) against the JAX
package's slab-causal RoPE attention: the Pallas kernel in interpret mode
at the smallest shape its pack plan admits, and the plain XLA chain below
the kernel's gate; K1's gate, and ``SelfAttention``'s plain route where it
shuts. float32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.models.layers import SelfAttention as JSelfAttention
from frankenstein_tpu.ops import attention as jattn
from frankenstein_tpu.ops import rope as jrope
from frankenstein_tpu.ops.pallas import block_attention
from frankenstein_tpu_torch.models.layers import SelfAttention
from frankenstein_tpu_torch.ops import attention as tattn
from frankenstein_tpu_torch.ops import rope as trope
from frankenstein_tpu_torch.ops.cuda import flash_attention, slab_attention

torch.set_num_threads(1)


def _qkv(seed, b, t, e, scale=0.3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, t, e)) * scale).astype(np.float32)
            for _ in range(3)]


def _tables(d, t):
    cache = jrope.build_rope_cache(d, t)
    return cache, trope.folded_tables(torch.tensor(np.asarray(cache)), 1)


def test_rope_tables_match_packed_tables():
    cache, (cos, sin) = _tables(32, 40)
    jcos, jsin = block_attention.rope_tables_packed(cache, 1)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))


def test_twin_matches_pallas_kernel_interpret():
    """B=1, T=1024, H=4, D=32, P=256: out and lse against
    ``_fwd_packed_rope_bte`` (the kernel K1 replaces) in interpret mode."""
    b, t, h, d, p = 1, 1024, 4, 32, 256
    q, k, v = _qkv(0, b, t, h * d)
    cache, (cos, sin) = _tables(d, t)
    npack = block_attention.PACK_LANES // d
    cos_pd, sin_pd = block_attention.rope_tables_packed(cache[-t:], npack)
    jout, lse4 = block_attention._fwd_packed_rope_bte(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cos_pd, sin_pd,
        block=p, n_heads=h, interpret=True)
    out, lse = slab_attention.slab_rope_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        cos, sin, n_heads=h, tok_per_time=p)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=3e-5)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse4).reshape(b, h, t), atol=3e-5)


@pytest.mark.parametrize("b,t,h,d,p", [(2, 64, 2, 16, 16), (1, 48, 3, 8, 5),
                                       (2, 32, 2, 8, 32)])
def test_twin_matches_plain_chain(b, t, h, d, p):
    """Below the kernel's gate the JAX package runs apply_rope +
    dot_product_attention(mask_mode="slab"); the twin matches it, and its
    lse is the logsumexp of the masked scores."""
    q, k, v = _qkv(1, b, t, h * d)
    cache, (cos, sin) = _tables(d, t + 7)      # longer table: suffix rows
    r4 = lambda x: jnp.asarray(x).reshape(b, t, h, d)
    qr, kr = jrope.apply_rope(r4(q), cache), jrope.apply_rope(r4(k), cache)
    want = jattn.dot_product_attention(qr, kr, r4(v), mask_mode="slab",
                                       tok_per_time=p, impl="xla")
    tcos, tsin = cos[-t:].contiguous(), sin[-t:].contiguous()
    out, lse = slab_attention.slab_rope_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tcos, tsin, n_heads=h, tok_per_time=p)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(want).reshape(b, t, h * d),
                               atol=1e-5)
    logits = np.einsum("bqhd,bkhd->bhqk", np.asarray(qr, np.float64),
                       np.asarray(kr, np.float64)) / np.sqrt(d)
    slab = np.arange(t) // p
    logits = np.where(slab[None, :] <= slab[:, None], logits, -np.inf)
    want_lse = np.log(np.exp(logits).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5)


def test_dispatch_matches_jax_dispatch_on_cpu():
    """``slab_attention_rope_fused`` on CPU tensors: same output as the JAX
    function (which falls back to its plain chain off-TPU), and no kernel
    launch is counted."""
    b, t, h, d, p = 2, 64, 2, 16, 16
    q, k, v = _qkv(2, b, t, h * d)
    cache = jrope.build_rope_cache(d, t)
    want = jattn.slab_attention_rope_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_heads=h,
        tok_per_time=p, rope_cache=cache)
    before = slab_attention.launches
    got = tattn.slab_attention_rope_fused(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        n_heads=h, tok_per_time=p, rope_cache=torch.tensor(np.asarray(cache)))
    assert slab_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_supported_rejects_what_k1_does_not_take():
    """On the card: f32, head_dim 16, T = 2400 (an MAE of 100 channels);
    the flagship encoder passes, and the CPU twin takes anything."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert slab_attention.supported("cuda", bf16, 6144, 256, 8)
    assert not slab_attention.supported("cuda", f32, 6144, 256, 8)
    assert not slab_attention.supported("cuda", bf16, 6144, 128, 8)
    assert not slab_attention.supported("cuda", bf16, 2400, 256, 8)
    assert not slab_attention.supported("cuda", bf16, 6144, 256, 7)
    assert slab_attention.supported("cpu", f32, 48, 24, 3)


@pytest.mark.parametrize("flash_gate", [True, False])
def test_self_attention_plain_route_matches_jax(monkeypatch, flash_gate):
    """With K1's gate shut, ``SelfAttention`` in the slab mode runs
    ``apply_rope`` + ``dot_product_attention`` (K7's slab twin where its
    gate holds, the plain path where it does not) and matches the JAX
    ``SelfAttention``, whose gate shuts off the TPU."""
    b, t, h, d, p = 2, 64, 2, 16, 16
    dim = h * d
    x = np.random.default_rng(3).standard_normal((b, t, dim)).astype(
        np.float32)
    cache = jrope.build_rope_cache(d, t + 8)
    kw = dict(mask_mode="slab", tok_per_time=p)
    jsa = JSelfAttention(dim=dim, n_heads=h, head_dim=d)
    params = jsa.init(jax.random.PRNGKey(4), jnp.asarray(x), rope=cache,
                      **kw)
    want = jsa.apply(params, jnp.asarray(x), rope=cache, **kw)
    sa = SelfAttention(dim, h, d)
    with torch.no_grad():
        for name in ("qw", "kw", "vw", "project"):
            getattr(sa, name).weight.copy_(torch.from_numpy(np.asarray(
                params["params"][name]["kernel"]).T))
    monkeypatch.setattr(slab_attention, "supported", lambda *a: False)
    if not flash_gate:
        monkeypatch.setattr(flash_attention, "supported", lambda *a: False)
    routes = []
    for mod, name in ((slab_attention, "slab_rope_attention"),
                      (flash_attention, "flash_attention")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            routes.append(_n), _r(*a, **k))[1])
    with torch.no_grad():
        got = sa(torch.from_numpy(x), rope=torch.tensor(np.asarray(cache)),
                 **kw)
    assert routes == (["flash_attention"] if flash_gate else [])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
