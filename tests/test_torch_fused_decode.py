"""Kernel K2's plain twin (``ops/cuda/fused_decode.py``) against the JAX
package's ``fused_decode_blocks`` in Pallas interpret mode, float32, in the
float and w8a16 modes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.ops.pallas import fused_decode as jfd
from frankenstein_tpu_torch.ops.cuda import fused_decode as tfd

torch.set_num_threads(1)

L, H, D, B, S = 2, 4, 32, 8, 16
E = H * D
VEC = {"ln1_w": E, "ln1_b": E, "qkv_b": 3 * E, "proj_b": E, "ln2_w": E,
       "ln2_b": E, "fc_b": 4 * E, "fc2_b": E}
MAT = {"qkv_w": (E, 3 * E), "proj_w": (E, E), "fc_w": (E, 4 * E),
       "fc2_w": (4 * E, E)}


def _weights(seed):
    rng = np.random.default_rng(seed)
    p = {k: (rng.standard_normal((L, n)) * 0.1).astype(np.float32)
         for k, n in VEC.items()}
    p["ln1_w"] += 1.0
    p["ln2_w"] += 1.0
    for k, shape in MAT.items():
        p[k] = (rng.standard_normal((L, *shape)) * 0.05).astype(np.float32)
    return p


def _caches(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((L, B, S, E)).astype(np.float32)
            for _ in range(2)]


def test_quantize_weights_matches_jax():
    p = _weights(0)
    jq = jfd.quantize_weights({k: jnp.asarray(v) for k, v in p.items()})
    tq = tfd.quantize_weights({k: torch.from_numpy(v) for k, v in p.items()})
    for key in tfd.WEIGHT_KEYS:
        assert tq[key].dtype == torch.int8
        np.testing.assert_array_equal(tq[key].numpy(), np.asarray(jq[key]))
    for key in tfd.SCALE_KEYS:
        assert tq[key].shape == jq[key].shape
        np.testing.assert_allclose(tq[key].numpy(), np.asarray(jq[key]),
                                   rtol=0, atol=1e-7)


@pytest.mark.parametrize("w8", [False, True])
def test_twin_matches_pallas_interpret(w8):
    """A 3-step chain (lengths 5, 6, 7): x_out within 1e-4 of the JAX
    kernel's; the row written at ``length`` within 1e-5 of the JAX kernel's
    (float32 products summed in another order, so not bit-equal); every
    other row bit-equal to what it was."""
    p = _weights(1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    if w8:
        jp, tp = jfd.quantize_weights(jp), tfd.quantize_weights(tp)
    kc0, vc0 = _caches(2)
    jk, jv = jnp.asarray(kc0), jnp.asarray(vc0)
    tk, tv = torch.from_numpy(kc0.copy()), torch.from_numpy(vc0.copy())
    rng = np.random.default_rng(3)
    for length in (5, 6, 7):
        x = rng.standard_normal((B, E)).astype(np.float32)
        jx, jk, jv = jfd.fused_decode_blocks(
            jnp.asarray(x), jp, jk, jv, jnp.int32(length), n_layer=L,
            n_head=H, head_dim=D, interpret=True)
        before_k = tk.clone()
        tx, tk_out, tv_out = tfd.fused_decode_blocks(
            torch.from_numpy(x), tp, tk, tv, length, n_head=H)
        assert tk_out is tk and tv_out is tv            # in place
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
        for got, want in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(got[:, :, length].numpy(),
                                       np.asarray(want)[:, :, length],
                                       atol=1e-5)
        others = [r for r in range(S) if r != length]
        np.testing.assert_array_equal(tk[:, :, others].numpy(),
                                      before_k[:, :, others].numpy())
    untouched = [r for r in range(S) if r not in (5, 6, 7)]
    np.testing.assert_array_equal(tv[:, :, untouched].numpy(),
                                  vc0[:, :, untouched])


def test_length_zero_attends_to_own_row_only():
    """With no cache rows the attention output is the token's own value, so
    the twin equals the JAX kernel there too."""
    p = _weights(4)
    kc0, vc0 = _caches(5)
    x = np.random.default_rng(6).standard_normal((B, E)).astype(np.float32)
    jx, _, _ = jfd.fused_decode_blocks(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(kc0), jnp.asarray(vc0), jnp.int32(0), n_layer=L,
        n_head=H, head_dim=D, interpret=True)
    tx, _, _ = tfd.fused_decode_blocks(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(kc0), torch.from_numpy(vc0), 0, n_head=H)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)


def test_int8_cache_refused_and_cpu_not_counted():
    """An int8 cache without its scales (or scales with a float cache) is
    refused; with them it is served, and on the CPU, in either mode, the
    twin runs and no kernel launch is counted."""
    p = {k: torch.from_numpy(v) for k, v in _weights(7).items()}
    kc = torch.zeros(L, B, S, E, dtype=torch.int8)
    scales = torch.full((L, 1, E), 0.01)
    with pytest.raises(ValueError, match="int8"):
        tfd.fused_decode_blocks(torch.zeros(B, E), p, kc, kc.clone(), 3,
                                n_head=H)
    with pytest.raises(ValueError, match="int8"):
        tfd.fused_decode_blocks(torch.zeros(B, E), p, torch.zeros(L, B, S, E),
                                torch.zeros(L, B, S, E), 3, scales, scales,
                                n_head=H)
    before = tfd.launches
    x, kc_out, _ = tfd.fused_decode_blocks(torch.ones(B, E), p, kc,
                                           kc.clone(), 3, scales, scales,
                                           n_head=H)
    assert kc_out is kc and kc_out.dtype == torch.int8
    assert torch.isfinite(x).all() and kc[:, :, 3].abs().sum() > 0
    tfd.fused_decode_blocks(torch.zeros(B, E), p, torch.zeros(L, B, S, E),
                            torch.zeros(L, B, S, E), 3, n_head=H)
    assert tfd.launches == before
