"""Kernel K10's plain twin (the ``qk_int8`` mode of
``ops/cuda/slab_attention.py``) against the JAX package's
``slab_causal_attention_rope(..., qk_int8=True)`` in Pallas interpret mode:
out, lse and gradients (K4's twin on the int8 forward's out and lse); its
drift from exact attention; a Franky encoder built with ``qk_int8``; and
the fallback signals of the paths K10 does not take (``qk_int8_fallback``).
float32 inputs, as the JAX package's own qk_int8 tests use, and one case on
the bf16 lattice against a float64 oracle of the documented math."""

import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from frankenstein_tpu.ops import rope as jrope
from frankenstein_tpu.ops.pallas import block_attention
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.models import brainformer as tbrain
from frankenstein_tpu_torch.models.franky import Franky
from frankenstein_tpu_torch.models.layers import SelfAttention
from frankenstein_tpu_torch.models.weights import init_franky_, init_mae_
from frankenstein_tpu_torch.ops import attention as tattn
from frankenstein_tpu_torch.ops import rope as trope
from frankenstein_tpu_torch.ops.cuda import slab_attention

torch.set_num_threads(1)

H, D, P = 8, 32, 256


def _setup(seed, b, t, scale=0.5):
    """Unit-scale q, k, v [B, T, H*D] (numpy f32), the rope cache and the
    port's folded tables."""
    rng = np.random.default_rng(seed)
    q, k, v = ((rng.standard_normal((b, t, H * D)) * scale).astype(np.float32)
               for _ in range(3))
    cache = jrope.build_rope_cache(D, t)
    cos, sin = trope.folded_tables(torch.tensor(np.asarray(cache)), 1)
    return q, k, v, cache, cos, sin


def _port(q, k, v, cos, sin, qk_int8):
    t = torch.from_numpy
    return slab_attention.slab_rope_attention(
        t(q), t(k), t(v), cos, sin, n_heads=H, tok_per_time=P,
        qk_int8=qk_int8)


@pytest.mark.parametrize("t", [1024, 2048])
def test_twin_matches_pallas_kernel_interpret(t):
    """b=1, h=8, d=32, p=256: out and lse within 1e-5 of
    ``_fwd_packed_rope_bte(qk_int8=True)``; t=2048 has two key chunks, so
    two K scales per head."""
    q, k, v, cache, cos, sin = _setup(61, 1, t)
    npack = block_attention.PACK_LANES // D
    cos_pd, sin_pd = block_attention.rope_tables_packed(cache[-t:], npack)
    jout, lse4 = block_attention._fwd_packed_rope_bte(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cos_pd, sin_pd,
        block=P, n_heads=H, interpret=True, qk_int8=True)
    before = (slab_attention.launches, slab_attention.launches_int8)
    out, lse = _port(q, k, v, cos, sin, True)
    assert (slab_attention.launches, slab_attention.launches_int8) == before
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse4).reshape(1, H, t), atol=1e-5)


def _k10_oracle(q, k, v, cos, sin, t, jax_scale=False):
    """numpy float64 oracle of K10's documented math on one batch of
    [T, H*D] f32 arrays: the rotation x*cos + (-x_odd | x_even)*sin in
    IEEE f32, rounded to bf16; s = max|x| / 127 + 1e-12 (an IEEE f32
    quotient) per (row, head) for q and per (1024-row chunk, head) for k,
    codes round_half_even(x / s); the integer dots dequantized,
    (dot * (scale * s_k)) * s_q, and the slab softmax in float64. Returns
    lse [H, T]. ``jax_scale`` takes s as the JAX interpret path gets it on
    the CPU: fma(max|x|, fl(1/127), 1e-12)."""
    f32 = np.float32

    def rotate(x):
        x = x.reshape(t, H, D // 2, 2)
        sw = np.stack([-x[..., 1], x[..., 0]], -1).reshape(t, H, D)
        r = x.reshape(t, H, D) * cos[:, None] + sw * sin[:, None]
        return r.astype(ml_dtypes.bfloat16).astype(f32)

    def codes(x, axes):
        mx = np.abs(x).max(axis=axes, keepdims=True)
        if jax_scale:
            s = (mx.astype(np.float64) * np.float64(f32(1) / f32(127))
                 + np.float64(f32(1e-12))).astype(f32)
        else:
            s = mx / f32(127) + f32(1e-12)
        return np.round(x / s).astype(np.float64), s.astype(np.float64)

    q8, sq = codes(rotate(q), (2,))                               # [T, H, 1]
    k8, sk = codes(rotate(k).reshape(t // 1024, 1024, H, D), (1, 3))
    k8 = k8.reshape(t, H, D)
    sk = np.repeat(sk[:, 0, :, 0], 1024, axis=0)                  # [T, H]
    i = np.arange(t)
    seen = (i[None, :] // P) <= (i[:, None] // P)
    lse = np.empty((H, t))
    for h in range(H):
        s = ((q8[:, h] @ k8[:, h].T) * ((1.0 / np.sqrt(D)) * sk[None, :, h])
             * sq[:, h])
        s[~seen] = -np.inf
        m = s.max(-1)
        lse[h] = m + np.log(np.exp(s - m[:, None]).sum(-1))
    return lse


def test_twin_matches_float64_oracle_on_the_bf16_lattice():
    """Unit-scale draws on the bf16 lattice (the serving dtype), real rope,
    t=2048: the twin's lse within 1e-5 of the float64 oracle of the
    documented math. The f32 draws above never reach the lattice's exact
    .5 ties in x / s; here a row whose max |x| is 127 * 2^e has the scale
    2^e exactly (the 1e-12 is below its last bit), so ties are common. The same oracle with the JAX
    interpret path's scale arithmetic (ROADMAP.md section 3) is more than
    1e-4 off: the check sees a tie rounded the other way."""
    t = 2048
    rng = np.random.default_rng(63)
    q, k, v = (rng.standard_normal((1, t, H * D)).astype(ml_dtypes.bfloat16)
               .astype(np.float32) for _ in range(3))
    cache = jrope.build_rope_cache(D, t)
    cos, sin = trope.folded_tables(torch.tensor(np.asarray(cache)), 1)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    _, lse = slab_attention.slab_rope_attention_int8_ref(
        bf(q), bf(k), bf(v), cos, sin, n_heads=H, tok_per_time=P)
    args = (q[0], k[0], v[0], cos.numpy(), sin.numpy(), t)
    np.testing.assert_allclose(lse[0].numpy(), _k10_oracle(*args), rtol=0,
                               atol=1e-5)
    assert np.abs(lse[0].numpy() - _k10_oracle(*args, jax_scale=True)
                  ).max() > 1e-4


def test_k_codes_and_scales():
    """The pre-pass twin: one scale per (batch, head, 1024-row chunk), the
    max |rotated k| / 127 + 1e-12 of that chunk, codes within [-127, 127]
    and equal to round-half-to-even(k / scale)."""
    _, k, _, _, cos, sin = _setup(62, 2, 2048)
    codes, scales = slab_attention.rope_quantize_k_ref(
        torch.from_numpy(k), cos, sin, n_heads=H)
    assert codes.dtype == torch.int8 and codes.shape == (2, 2048, H * D)
    assert scales.shape == (2, H, 2)
    rot = trope.apply_rope_folded(torch.from_numpy(k), cos.repeat(1, H),
                                  sin.repeat(1, H)).reshape(2, 2, 1024, H, D)
    want = rot.abs().amax(dim=(2, 4)) / 127.0 + 1e-12          # [B, 2, H]
    torch.testing.assert_close(scales, want.transpose(1, 2), rtol=1e-7,
                               atol=0)
    assert int(codes.abs().max()) == 127
    per = scales.transpose(1, 2).repeat_interleave(1024, dim=1)[..., None]
    np.testing.assert_array_equal(
        codes.float().numpy(),
        np.round((rot.reshape(2, 2048, H, D) / per).numpy()).reshape(
            2, 2048, H * D))


def test_drift_from_exact_is_serving_grade():
    """As ``tests/test_attention.py``'s qk_int8 tolerance test: at b=2,
    t=2048 the int8 output is within 1e-2 (max) and 1e-3 (mean) of exact
    attention, and differs from it."""
    q, k, v, _, cos, sin = _setup(57, 2, 2048)
    exact, _ = _port(q, k, v, cos, sin, False)
    quant, _ = _port(q, k, v, cos, sin, True)
    err = (quant - exact).abs()
    assert float(err.max()) < 1e-2 and float(err.mean()) < 1e-3
    assert float(err.max()) > 0.0


def _grads(fn, q, k, v, w):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (fn(*leaves) * torch.from_numpy(w)).sum().backward()
    return [a.grad.numpy() for a in leaves]


def test_gradients_match_jax_interpret_and_stay_near_exact():
    """K4's twin on the int8 forward's out and lse against ``jax.grad`` of
    the interpret qk_int8 path (1e-4 relative), and against the exact
    path's gradients (2e-2 relative, the JAX package's bound)."""
    q, k, v, cache, cos, sin = _setup(58, 1, 1024)
    w = np.random.default_rng(59).standard_normal(q.shape).astype(np.float32)
    jw = jnp.asarray(w)

    def loss(q, k, v):
        o = block_attention.slab_causal_attention_rope(
            q, k, v, P, cache, H, interpret=True, qk_int8=True)
        return jnp.sum(o * jw)

    want = jax.grad(loss, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v))
    attn = lambda qk_int8: (lambda a, b_, c: slab_attention.SlabRopeAttention
                            .apply(a, b_, c, cos, sin, H, P, qk_int8))
    got = _grads(attn(True), q, k, v, w)
    exact = _grads(attn(False), q, k, v, w)
    for g, jg, e in zip(got, want, exact):
        jg = np.asarray(jg)
        assert np.abs(g - jg).max() / np.abs(jg).max() < 1e-4
        assert np.abs(g - e).max() / np.abs(e).max() < 2e-2


def _franky_cfg(qk_int8, electrodes=256):
    """A tiny Franky whose encoder sees 4 slabs x ``electrodes`` tokens
    (1024 at the default: one K10 key chunk)."""
    return tconfig.FrankyConfig(
        brain=tconfig.PerceiverConfig(
            encoder=tconfig.MAEConfig(window_size=32, n_electrodes=electrodes,
                                      patch_size=8, dim=64, n_layers=2,
                                      head_dim=32, hidden_dim=128, n_heads=2,
                                      n_kv_heads=2, n_dec_layers=1,
                                      decoder_dim=64, qk_int8=qk_int8),
            n_output_tokens=4, output_dim=64, dim=64, n_layers=1,
            head_dim=32, hidden_dim=128, n_heads=2, n_kv_heads=2),
        gpt=tconfig.GPTConfig(block_size=64, vocab_size=300, n_layer=1,
                              n_head=2, n_embd=64),
        max_tokens=8, pad_token_id=299)


@pytest.fixture
def int8_calls(monkeypatch):
    calls = []
    real = slab_attention.slab_rope_attention_int8_ref
    monkeypatch.setattr(slab_attention, "slab_rope_attention_int8_ref",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    return calls


def test_franky_encoder_with_qk_int8(int8_calls):
    """Built with ``qk_int8``, the encoder runs K10's twin in each of its 2
    blocks, without a fallback warning; its context stays within the drift
    bound of the same weights' exact encode (``qk_int8=False``, which the
    JAX parity tests hold) and differs from it."""
    exact = init_franky_(Franky(_franky_cfg(False)), seed=3)
    quant = Franky(_franky_cfg(True))
    quant.load_state_dict(exact.state_dict())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, 256)).astype(np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.no_grad():
            got = quant.brain_model.encoder(x)
            prefix = quant.encode(x)
    assert len(int8_calls) == 2 * 2
    with torch.no_grad():
        want = exact.brain_model.encoder(x)
    err = (got - want).abs()
    assert float(err.max()) < 1e-2 and float(err.mean()) < 1e-3
    assert float(err.max()) > 0.0
    assert prefix.shape == (2, 4, 64) and torch.isfinite(prefix).all()


def test_encoder_short_of_a_key_chunk_falls_back_loudly(monkeypatch,
                                                        int8_calls):
    """32 tokens (T % 1024 != 0): each block warns and computes exact
    attention, equal to the exact model's; under FK_QK_INT8_STRICT=1 it
    raises."""
    cfg = _franky_cfg(True, electrodes=8)
    model = init_franky_(Franky(cfg), seed=4)
    exact = Franky(_franky_cfg(False, electrodes=8))
    exact.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 32, 8)).astype(np.float32))
    with pytest.warns(UserWarning, match="qk_int8") as rec:
        got = model.encode(x)
    assert len([r for r in rec if "qk_int8" in str(r.message)]) == 2
    assert torch.equal(got, exact.encode(x)) and not int8_calls
    monkeypatch.setenv("FK_QK_INT8_STRICT", "1")
    with pytest.raises(ValueError, match="qk_int8"):
        model.encode(x)


def test_fused_attention_fallback_signals(monkeypatch):
    """``slab_attention_rope_fused`` at T=512 warns and equals exact
    attention; under FK_QK_INT8_STRICT=1 it raises."""
    q, k, v, cache, _, _ = _setup(60, 1, 512, scale=0.3)
    t = torch.from_numpy
    kw = dict(n_heads=H, tok_per_time=128,
              rope_cache=torch.tensor(np.asarray(cache)))
    with pytest.warns(UserWarning, match="qk_int8"):
        out = tattn.slab_attention_rope_fused(t(q), t(k), t(v), qk_int8=True,
                                              **kw)
    assert torch.equal(out, tattn.slab_attention_rope_fused(t(q), t(k), t(v),
                                                            **kw))
    monkeypatch.setenv("FK_QK_INT8_STRICT", "1")
    with pytest.raises(ValueError, match="qk_int8"):
        tattn.slab_attention_rope_fused(t(q), t(k), t(v), qk_int8=True, **kw)


def test_self_attention_warns_when_its_gate_says_no(monkeypatch):
    """With K1's gate shut, ``SelfAttention(qk_int8=True)`` takes the plain
    route, warns, and computes what it computes without the flag."""
    monkeypatch.setattr(slab_attention, "supported", lambda *a: False)
    sa = SelfAttention(64, 2, 32)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 1024, 64)).astype(np.float32))
    rope = trope.build_rope_cache(32, 1024)
    kw = dict(mask_mode="slab", tok_per_time=256, rope=rope)
    with torch.no_grad():
        with pytest.warns(UserWarning, match="not K1's"):
            got = sa(x, qk_int8=True, **kw)
        assert torch.equal(got, sa(x, **kw))


def test_mae_trains_with_qk_int8_without_a_warning(int8_calls):
    """The MAE encodes only its kept tokens (``forward_subset``), which is
    never given the flag, as in the JAX package: a training step with
    ``qk_int8`` computes exact attention without a warning."""
    cfg = tconfig.MAEConfig(window_size=32, n_electrodes=256, patch_size=8,
                            dim=64, n_layers=1, head_dim=32, hidden_dim=128,
                            n_heads=2, n_kv_heads=2, n_dec_layers=1,
                            decoder_dim=64, qk_int8=True)
    model = init_mae_(tbrain.MAE(cfg), seed=8)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 32, 256)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loss, _ = model(x, generator=gen, train=True)
        loss.backward()
        opt.step()
    assert torch.isfinite(loss) and not int8_calls


def test_supported_gate():
    """With ``qk_int8`` the gate also demands T % 1024 == 0, on the CPU
    too; without it nothing changes."""
    bf16, f32 = torch.bfloat16, torch.float32
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert slab_attention.supported(cuda, bf16, 6144, 256, 8, True)
    assert not slab_attention.supported(cuda, bf16, 6272, 256, 8, True)
    assert slab_attention.supported(cuda, bf16, 6272, 256, 8)
    assert not slab_attention.supported(cuda, f32, 6144, 256, 8, True)
    assert not slab_attention.supported(cpu, f32, 512, 64, 2, True)
    assert slab_attention.supported(cpu, f32, 2048, 64, 2, True)
    assert slab_attention.supported(cpu, f32, 512, 64, 2)
