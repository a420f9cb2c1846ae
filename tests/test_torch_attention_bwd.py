"""Kernel K4's plain twin (``ops/cuda/slab_attention.py:
slab_rope_attention_bwd_ref``) and the autograd Function around K1 and K4,
against the JAX package's backward of the slab-causal RoPE attention: the
packed Pallas backward (``_bwd_packed``, the kernel K4 replaces) in
interpret mode, and ``jax.grad`` of the plain chain below the kernel's
gate. float32 throughout (float64 for gradcheck); inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.ops import attention as jattn
from frankenstein_tpu.ops import rope as jrope
from frankenstein_tpu.ops.pallas import block_attention
from frankenstein_tpu_torch.ops import rope as trope
from frankenstein_tpu_torch.ops.cuda import slab_attention

torch.set_num_threads(1)


def _arrays(seed, b, t, e, n=4, scale=0.3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, t, e)) * scale).astype(np.float32)
            for _ in range(n)]


def _twin_grads(q, k, v, do, cos, sin, h, p):
    """(dq, dk, dv) of sum(out * do) through the twins, as numpy."""
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = dict(n_heads=h, tok_per_time=p)
    out, lse = slab_attention.slab_rope_attention(tq, tk, tv, cos, sin, **kw)
    before = slab_attention.launches_bwd
    grads = slab_attention.slab_rope_attention_bwd(tq, tk, tv, cos, sin, out,
                                                   lse, tdo, **kw)
    assert slab_attention.launches_bwd == before   # CPU: the twin, no kernel
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("p", [256, 32])
def test_twin_matches_packed_pallas_backward_interpret(p):
    """B=1, T=1024, H=4, D=32 takes ``_bwd_packed`` in interpret mode at
    P=256 (K4's unmasked instance) and at P=32 (its masked one: P is no
    multiple of 64); the JAX forward's pack plan takes only slabs that
    divide its 512-row query block. atol 2e-4 as tests/test_attention.py
    holds that backward."""
    b, t, h, d = 1, 1024, 4, 32
    assert block_attention._bwd_packed_supported(t, d, 4, 4, p,
                                                 interpret=True)
    q, k, v, do = _arrays(0, b, t, h * d)
    cache = jrope.build_rope_cache(d, t)

    def loss(q, k, v):
        out = block_attention.slab_causal_attention_rope(
            q, k, v, p, cache, h, interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    cos, sin = trope.folded_tables(torch.tensor(np.asarray(cache)), 1)
    got = _twin_grads(q, k, v, do, cos, sin, h, p)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4, err_msg=name)


@pytest.mark.parametrize("b,t,h,d,p", [(2, 64, 2, 16, 16), (1, 48, 3, 8, 5),
                                       (2, 32, 2, 8, 32)])
def test_twin_matches_plain_chain_grad(b, t, h, d, p):
    """Below the kernel's gate the JAX package differentiates apply_rope +
    dot_product_attention(mask_mode="slab"); P need not divide T."""
    q, k, v, do = _arrays(1, b, t, h * d)
    cache = jrope.build_rope_cache(d, t + 7)      # longer table: suffix rows
    r4 = lambda x: x.reshape(b, t, h, d)

    def loss(q, k, v):
        out = jattn.dot_product_attention(
            jrope.apply_rope(r4(q), cache), jrope.apply_rope(r4(k), cache),
            r4(v), mask_mode="slab", tok_per_time=p, impl="xla")
        return jnp.sum(out.reshape(b, t, h * d) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    cos, sin = trope.folded_tables(torch.tensor(np.asarray(cache)), 1)
    got = _twin_grads(q, k, v, do, cos[-t:].contiguous(),
                      sin[-t:].contiguous(), h, p)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, err_msg=name)


def _leaves(arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]


def test_function_matches_autograd_through_forward_twin():
    """The Function's backward (the K4 twin) equals autograd through the
    plain forward twin; cos and sin get no gradient."""
    b, t, h, d, p = 2, 40, 2, 8, 12
    q, k, v, do = _arrays(2, b, t, h * d)
    cos, sin = trope.folded_tables(trope.build_rope_cache(d, t), 1)
    cos.requires_grad_(True)
    tdo = torch.from_numpy(do)
    fn = _leaves((q, k, v))
    out = slab_attention.SlabRopeAttention.apply(*fn, cos, sin, h, p)
    (out * tdo).sum().backward()
    assert cos.grad is None
    ref = _leaves((q, k, v))
    ref_out, _ = slab_attention.slab_rope_attention_ref(
        *ref, cos.detach(), sin, n_heads=h, tok_per_time=p)
    (ref_out * tdo).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref_out.detach().numpy())
    for name, a, r in zip("qkv", fn, ref):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), atol=1e-6,
                                   err_msg=name)


def test_function_gradcheck_float64():
    b, t, h, d, p = 1, 12, 2, 4, 5
    q, k, v = _arrays(3, b, t, h * d, n=3)
    cos, sin = (x.double() for x in trope.folded_tables(
        trope.build_rope_cache(d, t), 1))
    fn = lambda q, k, v: slab_attention.SlabRopeAttention.apply(
        q, k, v, cos, sin, h, p)
    assert torch.autograd.gradcheck(fn, _leaves((q, k, v), torch.float64))


def test_twin_probability_rows_sum_to_one():
    """dout one-hot on (query i_c, lane c) makes column c of dv row i_c of
    the recomputed probabilities; each row sums to 1 against the forward's
    lse (the check the card test makes of K4 itself)."""
    b, t, h, d, p = 1, 64, 2, 8, 16
    q, k, v = _arrays(4, b, t, h * d, n=3)
    cos, sin = trope.folded_tables(trope.build_rope_cache(d, t), 1)
    rows = np.arange(d) * 7 % t
    do = np.zeros((b, t, h * d), np.float32)
    for head in range(h):
        do[0, rows, head * d + np.arange(d)] = 1.0
    _, _, dv = _twin_grads(q, k, v, do, cos, sin, h, p)
    sums = dv.reshape(b, t, h, d).sum(axis=1)        # [b, h, d]
    np.testing.assert_allclose(sums, 1.0, atol=1e-5)
