"""Kernel K5's plain twin (``ops/cuda/fused_llama_decode.py``) against the
JAX package's ``fused_llama_decode_blocks`` in Pallas interpret mode: the
geometry of ``tests/test_llama.py``'s fused-decode tests (E=256, 4 heads, 2
KV heads, F=256, B=8, S=16), in all four modes (float or w8a16 weights,
float or int8 cache), with one KV head per query head too, a 3-step chain
across row 8, and the JAX big-model kernel (``FK_LLAMA_BIG=1``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.ops.pallas import fused_llama_decode as jfld
from frankenstein_tpu_torch.ops import rope
from frankenstein_tpu_torch.ops.cuda import fused_llama_decode as tfld

torch.set_num_threads(1)

E, H, F, B, S, EPS = 256, 4, 256, 8, 16, 1e-5
D = E // H


def _weights(n_layers, n_kv, seed):
    rng = np.random.default_rng(seed)
    ekv = n_kv * D
    p = {k: (1.0 + 0.1 * rng.standard_normal((n_layers, E))).astype(
        np.float32) for k in ("norm1_w", "norm2_w")}
    for key, shape in {"wq": (E, E), "wk": (E, ekv), "wv": (E, ekv),
                       "wo": (E, E), "wg": (E, F), "wu": (E, F),
                       "wd": (F, E)}.items():
        p[key] = (0.05 * rng.standard_normal((n_layers, *shape))).astype(
            np.float32)
    return p


def _caches(n_layers, n_kv, seed, int8: bool):
    """(k, v, k_scale, v_scale) numpy arrays; scales None for f32."""
    rng = np.random.default_rng(seed)
    shape = (n_layers, B, S, n_kv * D)
    if not int8:
        return (rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32), None, None)
    codes = [rng.integers(-127, 128, shape).astype(np.int8) for _ in "kv"]
    scales = [(0.01 + 0.02 * rng.random((n_layers, 1, n_kv * D))).astype(
        np.float32) for _ in "kv"]
    return codes[0], codes[1], scales[0], scales[1]


def _rope_rows(length):
    cos, sin = rope.folded_tables(rope.build_rope_cache(D, S), H)
    return cos[length:length + 1], sin[length:length + 1]


def _both(p, w8):
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    if w8:
        jp, tp = jfld.quantize_weights(jp), tfld.quantize_weights(tp)
    return jp, tp


def _step(jp, tp, caches, x, length, n_layers, n_kv):
    """One step on both sides; returns (jax outputs, twin outputs, the
    twin's caches before the step)."""
    jk, jv, tk, tv, ks, vs = caches
    before = (tk.clone(), tv.clone())
    cos, sin = _rope_rows(length)
    jout = jfld.fused_llama_decode_blocks(
        jnp.asarray(x), jp, jk, jv, jnp.int32(length), jnp.asarray(cos),
        jnp.asarray(sin), None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), n_layers=n_layers,
        n_heads=H, head_dim=D, n_kv_heads=n_kv, hidden=F, eps=EPS,
        interpret=True)
    tout = tfld.fused_llama_decode_blocks(
        torch.from_numpy(x), tp, tk, tv, length, cos, sin,
        None if ks is None else torch.from_numpy(ks),
        None if vs is None else torch.from_numpy(vs), n_heads=H,
        n_kv_heads=n_kv, eps=EPS)
    return jout, tout, before


def _compare(jout, tout, length, int8: bool, before):
    """x_out within 5e-4 of max |x|; int8 caches equal to the JAX kernel's
    code for code; float caches: the new row within 5e-5 of the JAX
    kernel's, every other row as it was before the step."""
    jx, jk, jv = jout
    tx, tk, tv = tout
    jx = np.asarray(jx)
    np.testing.assert_allclose(tx.numpy(), jx, atol=5e-4 * np.abs(jx).max(),
                               rtol=0)
    others = [r for r in range(S) if r != length]
    for got, want, old in ((tk, jk, before[0]), (tv, jv, before[1])):
        got, want = got.numpy(), np.asarray(want)
        if int8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got[:, :, length],
                                       want[:, :, length], atol=5e-5)
        np.testing.assert_array_equal(got[:, :, others],
                                      old.numpy()[:, :, others])


def test_quantize_weights_matches_jax():
    p = _weights(2, 2, 0)
    jq = jfld.quantize_weights({k: jnp.asarray(v) for k, v in p.items()})
    tq = tfld.quantize_weights({k: torch.from_numpy(v) for k, v in p.items()})
    assert set(tq) == set(jq)
    for key in tfld.WEIGHT_KEYS:
        assert tq[key].dtype == torch.int8
        np.testing.assert_array_equal(tq[key].numpy(), np.asarray(jq[key]))
        np.testing.assert_allclose(tq[key + "_s"].numpy(),
                                   np.asarray(jq[key + "_s"]), rtol=0,
                                   atol=1e-7)


@pytest.mark.parametrize("w8,int8,n_kv", [(False, False, 2), (True, False, 2),
                                          (False, True, 2), (True, True, 2),
                                          (False, False, 4)])
def test_twin_matches_pallas_interpret(w8, int8, n_kv):
    """One step at length 9: x_out within 5e-4 of max |x|; the float new
    rows within 5e-5 and every other row unchanged; int8 caches equal code
    for code. ``n_kv=4`` is one KV head per query head."""
    n_layers = 2
    jp, tp = _both(_weights(n_layers, n_kv, 1), w8)
    k, v, ks, vs = _caches(n_layers, n_kv, 2, int8)
    x = np.random.default_rng(3).standard_normal((B, E)).astype(np.float32)
    caches = (jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k.copy()),
              torch.from_numpy(v.copy()), ks, vs)
    jout, tout, before = _step(jp, tp, caches, x, 9, n_layers, n_kv)
    assert tout[1] is caches[2] and tout[2] is caches[3]       # in place
    _compare(jout, tout, 9, int8, before)


@pytest.mark.parametrize("int8", [False, True])
def test_three_step_chain_from_length_7(int8):
    """Rows 7, 8 and 9 written by three chained steps; each step's x_out
    and the caches track the JAX kernel's."""
    n_layers, n_kv = 2, 2
    jp, tp = _both(_weights(n_layers, n_kv, 4), False)
    k, v, ks, vs = _caches(n_layers, n_kv, 5, int8)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    rng = np.random.default_rng(6)
    for length in (7, 8, 9):
        x = rng.standard_normal((B, E)).astype(np.float32)
        jout, tout, before = _step(jp, tp, (jk, jv, tk, tv, ks, vs), x,
                                   length, n_layers, n_kv)
        _compare(jout, tout, length, int8, before)
        jk, jv = jout[1], jout[2]


def test_length_zero_attends_to_own_row_only():
    n_layers, n_kv = 2, 2
    jp, tp = _both(_weights(n_layers, n_kv, 7), False)
    k, v, _, _ = _caches(n_layers, n_kv, 8, False)
    x = np.random.default_rng(9).standard_normal((B, E)).astype(np.float32)
    caches = (jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k.copy()),
              torch.from_numpy(v.copy()), None, None)
    jout, tout, before = _step(jp, tp, caches, x, 0, n_layers, n_kv)
    _compare(jout, tout, 0, False, before)


@pytest.mark.parametrize("hc", [1, 2])
@pytest.mark.parametrize("int8", [False, True])
def test_twin_matches_jax_bigmodel_kernel(monkeypatch, hc, int8):
    """The JAX big-model kernel (chunked MLP, ``hc`` hidden chunks) computes
    the same step up to f32 reassociation: the one CUDA kernel (and so its
    twin) covers its contract. 3 layers, as ``tests/test_llama.py``'s
    big-model test."""
    monkeypatch.setenv("FK_LLAMA_BIG", "1")
    monkeypatch.setenv("FK_LLAMA_BIG_HC", str(hc))
    jfld.fused_llama_decode_blocks._clear_cache()
    try:
        n_layers, n_kv, length = 3, 2, 5
        jp, tp = _both(_weights(n_layers, n_kv, 10), False)
        k, v, ks, vs = _caches(n_layers, n_kv, 11, int8)
        x = np.random.default_rng(12).standard_normal((B, E)).astype(
            np.float32)
        caches = (jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k.copy()),
                  torch.from_numpy(v.copy()), ks, vs)
        (jx, jk, _), (tx, tk, _), _ = _step(jp, tp, caches, x, length,
                                             n_layers, n_kv)
    finally:
        jfld.fused_llama_decode_blocks._clear_cache()
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=2e-3,
                               rtol=1e-3)
    if int8:
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    else:
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=2e-3,
                                   rtol=1e-3)


def test_refusals_and_cpu_not_counted():
    """An int8 cache without its scales (or scales with a float cache) is
    refused; on the CPU the twin runs and no launch is counted."""
    n_layers, n_kv = 1, 2
    tp = {k: torch.from_numpy(v) for k, v in _weights(n_layers, n_kv,
                                                       13).items()}
    cos, sin = _rope_rows(3)
    kc = torch.zeros(n_layers, B, S, n_kv * D, dtype=torch.int8)
    scales = torch.full((n_layers, 1, n_kv * D), 0.01)
    kw = dict(n_heads=H, n_kv_heads=n_kv, eps=EPS)
    with pytest.raises(ValueError, match="int8"):
        tfld.fused_llama_decode_blocks(torch.zeros(B, E), tp, kc, kc.clone(),
                                       3, cos, sin, **kw)
    with pytest.raises(ValueError, match="int8"):
        tfld.fused_llama_decode_blocks(
            torch.zeros(B, E), tp, torch.zeros(n_layers, B, S, n_kv * D),
            torch.zeros(n_layers, B, S, n_kv * D), 3, cos, sin, scales,
            scales, **kw)
    before = (tfld.launches, tfld.launches_int8_kv)
    x, kc_out, _ = tfld.fused_llama_decode_blocks(
        torch.ones(B, E), tp, kc, kc.clone(), 3, cos, sin, scales, scales,
        **kw)
    assert kc_out is kc and torch.isfinite(x).all()
    assert kc[:, :, 3].abs().sum() > 0
    assert (tfld.launches, tfld.launches_int8_kv) == before
