"""The int8 KV cache of the port against the JAX package: the quantization
helpers of ``ops/cuda/fused_decode.py``, kernel K2's plain twin in its
int8-KV mode against the Pallas ``fused_decode_blocks`` in interpret mode
(float32), ``QuantCache`` through ``decode_step`` and ``generate``, and K2's
gate with the plain route ``decode_step`` takes where it shuts."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.config import GPTConfig as JGPTConfig
from frankenstein_tpu.decode import sampling as jsampling
from frankenstein_tpu.models import gpt2 as jgpt2
from frankenstein_tpu.models.import_reference import export_gpt
from frankenstein_tpu.ops.pallas import fused_decode as jfd
from frankenstein_tpu_torch.config import GPTConfig
from frankenstein_tpu_torch.decode import sampling
from frankenstein_tpu_torch.models import gpt2
from frankenstein_tpu_torch.models.weights import load_strict
from frankenstein_tpu_torch.ops.cuda import fused_decode as tfd

torch.set_num_threads(1)

L, H, D, B, S = 2, 2, 64, 8, 16
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


def _float_cache(seed, shape=(L, B, S, E)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 2.0


def test_quantize_cache_side_matches_jax():
    c = _float_cache(0)
    c[1, :, :, 5] = 0.0                       # an all-zero lane: the floor
    jcodes, jscales = jfd.quantize_cache_side(jnp.asarray(c))
    codes, scales = tfd.quantize_cache_side(torch.from_numpy(c))
    assert codes.dtype == torch.int8 and scales.shape == (L, 1, E)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(scales.numpy(), np.asarray(jscales), rtol=0,
                               atol=1e-7)


def test_quantize_rows_and_with_scales_match_jax():
    """Fixed scales: new rows and a whole cache quantize alike (clipping
    included, since the values overshoot the scales' range), and the
    dequantized cache round-trips to its codes."""
    _, jscales = jfd.quantize_cache_side(jnp.asarray(_float_cache(1)))
    scales = torch.from_numpy(np.array(jscales))
    rows = _float_cache(2, (L, B, E)) * 1.5
    np.testing.assert_array_equal(
        tfd.quantize_rows(torch.from_numpy(rows), scales).numpy(),
        np.asarray(jfd.quantize_rows(jnp.asarray(rows), jscales)))
    full = _float_cache(3) * 1.5
    codes = tfd.quantize_with_scales(torch.from_numpy(full), scales)
    np.testing.assert_array_equal(
        codes.numpy(),
        np.asarray(jfd.quantize_with_scales(jnp.asarray(full), jscales)))
    assert int(codes.abs().max()) == 127
    deq = tfd.dequantize_cache_side(codes, scales, torch.float32)
    jdeq = jfd.dequantize_cache_side(jnp.asarray(codes.numpy()), jscales,
                                     jnp.float32)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(
        tfd.quantize_with_scales(deq, scales).numpy(), codes.numpy())


def test_rounding_is_half_to_even():
    scales = torch.ones(1, 1, 4)
    rows = torch.tensor([[[0.5, 1.5, -2.5, 200.0]]])
    assert tfd.quantize_rows(rows, scales).tolist() == [[[0, 2, -2, 127]]]


def test_twin_int8_matches_pallas_interpret():
    """A 3-step chain (lengths 5, 6, 7) on int8 caches: x_out within 1e-4
    of the JAX kernel's, the codes written at ``length`` equal to the JAX
    kernel's, every other row bit-equal to what it was."""
    p = _weights(4)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jk, jks = jfd.quantize_cache_side(jnp.asarray(_float_cache(5)))
    jv, jvs = jfd.quantize_cache_side(jnp.asarray(_float_cache(6)))
    tk = torch.from_numpy(np.array(jk))
    tv = torch.from_numpy(np.array(jv))
    ks = torch.from_numpy(np.array(jks))
    vs = torch.from_numpy(np.array(jvs))
    k0, v0 = tk.clone(), tv.clone()
    rng = np.random.default_rng(7)
    for length in (5, 6, 7):
        x = rng.standard_normal((B, E)).astype(np.float32)
        jx, jk, jv = jfd.fused_decode_blocks(
            jnp.asarray(x), jp, jk, jv, jnp.int32(length), jks, jvs,
            n_layer=L, n_head=H, head_dim=D, interpret=True)
        before = tk.clone()
        tx, tk_out, tv_out = tfd.fused_decode_blocks(
            torch.from_numpy(x), tp, tk, tv, length, ks, vs, n_head=H)
        assert tk_out is tk and tv_out is tv            # in place
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        others = [r for r in range(S) if r != length]
        np.testing.assert_array_equal(tk[:, :, others].numpy(),
                                      before[:, :, others].numpy())
    untouched = [r for r in range(S) if r not in (5, 6, 7)]
    np.testing.assert_array_equal(tv[:, :, untouched].numpy(),
                                  v0[:, :, untouched].numpy())
    assert not torch.equal(tk[:, :, 5:8], k0[:, :, 5:8])


def test_int8_mode_is_the_float_mode_on_dequantized_rows():
    """With a float cache holding the dequantized codes, the float mode
    computes the same x (the scales fold into q and the AV sum exactly, up
    to f32 rounding) and its new rows quantize to the int8 mode's codes."""
    p = {k: torch.from_numpy(v) for k, v in _weights(8).items()}
    kq, ks = tfd.quantize_cache_side(torch.from_numpy(_float_cache(9)))
    vq, vs = tfd.quantize_cache_side(torch.from_numpy(_float_cache(10)))
    kf = tfd.dequantize_cache_side(kq, ks, torch.float32)
    vf = tfd.dequantize_cache_side(vq, vs, torch.float32)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (B, E)).astype(np.float32))
    xq, kq, vq = tfd.fused_decode_blocks_ref(x, p, kq, vq, 9, ks, vs,
                                             n_head=H)
    xf, kf, vf = tfd.fused_decode_blocks_ref(x, p, kf, vf, 9, n_head=H)
    np.testing.assert_allclose(xq.numpy(), xf.numpy(), atol=1e-5)
    np.testing.assert_array_equal(
        tfd.quantize_with_scales(kf, ks).numpy(), kq.numpy())


def test_twin_writes_half_to_even_codes_of_exact_rows():
    """With qkv_w = 0 the new K/V rows are the qkv bias exactly, so the
    codes are clamp(round-half-to-even(bias / scale)) on .5 ties too."""
    p = {k: torch.from_numpy(v) for k, v in _weights(13).items()}
    p["qkv_w"] = torch.zeros_like(p["qkv_w"])
    t = torch.tensor([0.5, 1.5, 2.5, -0.5, -3.5, 126.5, 127.5, -200.0,
                      3.25] * 15)[:E].repeat(L, 1)
    scale = torch.full((L, 1, E), 0.125)
    p["qkv_b"][:, E:2 * E] = t * 0.125
    p["qkv_b"][:, 2 * E:] = -t * 0.125
    kc = torch.zeros(L, B, S, E, dtype=torch.int8)
    vc = torch.zeros_like(kc)
    tfd.fused_decode_blocks(torch.ones(B, E), p, kc, vc, 4, scale, scale,
                            n_head=H)
    want = torch.clamp(torch.round(t), -127, 127).to(torch.int8)
    assert want[0, :9].tolist() == [0, 2, 2, 0, -4, 126, 127, -127, 3]
    assert torch.equal(kc[:, :, 4], want[:, None].expand(L, B, E))
    assert torch.equal(vc[:, :, 4], -want[:, None].expand(L, B, E))


def test_int8_compute_dtype_follows_jax():
    w = {"qkv_w": torch.zeros(1, dtype=torch.int8)}
    assert tfd._compute_dtype(w, torch.zeros(1, dtype=torch.int8)) \
        == torch.bfloat16
    assert tfd._compute_dtype(w, torch.zeros(1)) == torch.float32
    assert tfd._compute_dtype({"qkv_w": torch.zeros(1)},
                              torch.zeros(1, dtype=torch.int8)) \
        == torch.float32


@pytest.fixture(scope="module")
def tiny_gpt():
    cfg = dict(block_size=32, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
    jmodel = jgpt2.GPT(JGPTConfig(**cfg))
    idx0 = np.random.default_rng(12).integers(0, 96, (4, 5)).astype(np.int32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(idx0))
    model = load_strict(gpt2.GPT(GPTConfig(**cfg)), export_gpt(params))
    return jmodel, params, model, idx0


def test_quant_cache_decode_step_matches_jax(tiny_gpt):
    """decode_step on a QuantCache (the JAX package's dequantize fallback on
    the CPU, K2's int8 twin in the port): logits within 1e-4, the same
    codes, the scales passed through unchanged."""
    jmodel, params, model, idx0 = tiny_gpt
    jcache = jgpt2.init_cache(jmodel.cfg, 4, 16)
    jlogits, jcache, jlen = jmodel.apply(params, jnp.asarray(idx0), None,
                                         jcache, method=jgpt2.GPT.prefill)
    jq = jgpt2.quantize_cache(jcache)
    logits, cache, length = model.prefill(torch.from_numpy(idx0).long(),
                                          None, model.init_decode_cache(4, 16))
    q = gpt2.quantize_cache(cache)
    np.testing.assert_array_equal(q.k.numpy(), np.asarray(jq.k))
    qw = sampling.decode_weights(model, int8_weights=False)
    for _ in range(3):
        tok = torch.argmax(logits, dim=-1)
        jlogits, jq, jlen = jmodel.apply(
            params, jnp.asarray(tok.numpy(), jnp.int32), jq, jlen,
            method=jgpt2.GPT.decode_step)
        scales = q.k_scale
        logits, q, length = model.decode_step(tok, q, length, qw)
        assert isinstance(q, gpt2.QuantCache) and q.k_scale is scales
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4)
        np.testing.assert_array_equal(q.k.numpy(), np.asarray(jq.k))
        np.testing.assert_array_equal(q.v.numpy(), np.asarray(jq.v))
    assert length == int(jlen)


def test_generate_int8_kv_greedy_matches_jax(tiny_gpt):
    jmodel, params, model, idx0 = tiny_gpt
    want = jsampling.generate(jmodel, params, jnp.asarray(idx0), None,
                              jax.random.key(0), max_new_tokens=6,
                              greedy=True, int8_kv=True)
    got = sampling.generate(model, torch.from_numpy(idx0).long(), None,
                            max_new_tokens=6, greedy=True, int8_kv=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_supported_rejects_what_k2_does_not_take():
    """On the card: E % 128 != 0, f32 x or cache, a head_dim that is not a
    multiple of 16 with an int8 cache; GPT-2 124M passes in every mode, and
    the CPU twin takes anything."""
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    for w, c in ((bf16, bf16), (i8, bf16), (bf16, i8), (i8, i8)):
        assert tfd.supported("cuda", bf16, w, c, 768, 12)
    assert not tfd.supported("cuda", bf16, bf16, bf16, 192, 3)
    assert not tfd.supported("cuda", f32, f32, f32, 768, 12)
    assert not tfd.supported("cuda", bf16, bf16, f32, 768, 12)
    assert not tfd.supported("cuda", bf16, bf16, i8, 768, 96)
    assert tfd.supported("cpu", f32, f32, f32, 32, 2)


def _decode_chain(model, idx0, int8_kv: bool, toks=None, steps: int = 3):
    """Prefill, then ``steps`` decode steps (greedy, or the tokens
    ``toks``): (the logits of each step, the tokens fed, the final cache);
    each step's cache is the tensors it was given (in place)."""
    b = idx0.shape[0]
    logits, cache, length = model.prefill(torch.from_numpy(idx0).long(),
                                          None, model.init_decode_cache(b, 16))
    if int8_kv:
        cache = gpt2.quantize_cache(cache)
    qw = sampling.decode_weights(model, int8_weights=False)
    out, fed = [], []
    for i in range(steps):
        tok = torch.argmax(logits, dim=-1) if toks is None else toks[i]
        logits, new, length = model.decode_step(tok, cache, length, qw)
        assert new[0] is cache[0] and new[1] is cache[1]
        if int8_kv:
            assert new.k_scale is cache.k_scale
        cache = new
        out.append(logits)
        fed.append(tok)
    return out, fed, cache


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_decode_step_plain_route_matches_twin(tiny_gpt, monkeypatch, kind):
    """With K2's gate shut ``decode_step`` runs the module blocks (the JAX
    package's scanned fallback; a ``QuantCache`` dequantized around them
    and requantized in place with its own scales), fed the twin's tokens.
    A bf16 model with a bf16 cache gives the twin's logits within 3e-2 of
    their largest (bf16 rounding: the twin keeps an f32 residual, the
    blocks a bf16 one); an f32 model with an int8 cache within 1e-4, code
    for code."""
    _, _, model, idx0 = tiny_gpt
    if kind == "bf16":
        model = copy.deepcopy(model).to(torch.bfloat16)
    int8_kv = kind == "int8"
    want, toks, want_cache = _decode_chain(model, idx0, int8_kv)
    monkeypatch.setattr(tfd, "supported", lambda *a: False)
    calls = []
    real = tfd.fused_decode_blocks_ref
    monkeypatch.setattr(tfd, "fused_decode_blocks_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, _, cache = _decode_chain(model, idx0, int8_kv, toks)
    assert calls == []
    for g, w in zip(got, want):
        if int8_kv:
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4)
        else:
            assert float((g - w).abs().max()) <= 3e-2 * float(w.abs().max())
    for g, w in zip(cache[:2], want_cache[:2]):
        if int8_kv:
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        else:
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       atol=3e-2, rtol=3e-2)


def test_decode_step_plain_route_refuses_int8_weights(tiny_gpt, monkeypatch):
    """int8 block weights need K2: off it ``decode_step`` raises, as the
    JAX package does."""
    _, _, model, idx0 = tiny_gpt
    logits, cache, length = model.prefill(torch.from_numpy(idx0).long(), None,
                                          model.init_decode_cache(4, 16))
    qw = sampling.decode_weights(model, int8_weights=True)
    monkeypatch.setattr(tfd, "supported", lambda *a: False)
    with pytest.raises(NotImplementedError, match="K2"):
        model.decode_step(torch.argmax(logits, dim=-1), cache, length, qw)
