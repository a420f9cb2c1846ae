"""The port's LLaMA (``models/llama.py``) against the JAX package's, float32,
on ``tiny_llama_config`` (4 query heads on 2 KV heads, so a swapped GQA
mapping shows): forward loss and logits, ``sequence_logprob``, prefill
plus cached decode steps (on the CPU the JAX package decodes with its
scanned blocks and the port with kernel K5's twin), K5's gate and the plain
route ``decode_step`` takes where it shuts, n-best candidates and
rescoring, ``expand_cache``, and the HF import against
``transformers.LlamaForCausalLM``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.models import gpt2 as jgpt2
from frankenstein_tpu.models import llama as jllama
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.decode import sampling
from frankenstein_tpu_torch.models import gpt2, llama
from frankenstein_tpu_torch.models.weights import (llama_state_from_flax,
                                                   load_strict)
from frankenstein_tpu_torch.ops.cuda import fused_llama_decode

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    """(jax module, jax params, port model); every leaf perturbed, so the
    unit-initialised norms are tested too."""
    cfg = jllama.tiny_llama_config()
    jmodel = jllama.Llama(cfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    model = load_strict(llama.Llama(tconfig.tiny_llama_config()),
                        llama_state_from_flax(tree))
    return jmodel, params, model


def test_forward_loss_and_logits(pair):
    jmodel, params, model = pair
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 128, (2, 6))
    tgt = idx.copy()
    tgt[:, 4:] = -100
    prefix = rng.standard_normal((2, 3, 32)).astype(np.float32)
    jloss, jlogits = jmodel.apply(params, jnp.asarray(idx),
                                  jnp.asarray(prefix), jnp.asarray(tgt))
    with torch.no_grad():
        loss, logits = model(torch.from_numpy(idx), torch.from_numpy(prefix),
                             torch.from_numpy(tgt))
    assert logits.shape == (2, 6, 128)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)


@pytest.mark.parametrize("with_prefix", [False, True])
def test_sequence_logprob(pair, with_prefix):
    jmodel, params, model = pair
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 128, (3, 7))
    idx[0, 5:] = -100
    idx[2, 3:] = -100
    prefix = (rng.standard_normal((3, 2, 32)).astype(np.float32)
              if with_prefix else None)
    want = jmodel.apply(params, jnp.asarray(idx),
                        None if prefix is None else jnp.asarray(prefix),
                        method=jllama.Llama.sequence_logprob)
    with torch.no_grad():
        got = model.sequence_logprob(
            torch.from_numpy(idx),
            None if prefix is None else torch.from_numpy(prefix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("int8_kv", [False, True])
def test_prefill_and_decode_steps(pair, int8_kv):
    """Prefill with a prefix, then 4 greedy decode steps: the tokens
    identical, logits within 1e-4, caches within 1e-5 (int8: code for
    code), and no kernel launch counted on the CPU."""
    jmodel, params, model = pair
    rng = np.random.default_rng(3)
    idx0 = rng.integers(0, 128, (2, 3))
    prefix = rng.standard_normal((2, 2, 32)).astype(np.float32)
    jcache = jllama.init_llama_cache(jmodel.cfg, 2, 16)
    jlogits, jcache, jlen = jmodel.apply(
        params, jnp.asarray(idx0), jnp.asarray(prefix), jcache,
        method=jllama.Llama.prefill)
    cache = model.init_decode_cache(2, 16)
    assert cache[0].shape == (2, 2, 16, 16)          # KV heads unexpanded
    logits, cache, length = model.prefill(torch.from_numpy(idx0),
                                          torch.from_numpy(prefix), cache)
    assert length == int(jlen) == 5
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    if int8_kv:
        jcache = jgpt2.quantize_cache(jcache)
        cache = gpt2.quantize_cache(cache)
    qweights = sampling.decode_weights(model, int8_weights=False)
    before = fused_llama_decode.launches
    for _ in range(4):
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits, dim=-1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlogits, jcache, jlen = jmodel.apply(params, jtok, jcache, jlen,
                                             method=jllama.Llama.decode_step)
        logits, cache, length = model.decode_step(tok, cache, length,
                                                  qweights)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4)
    assert length == int(jlen) == 9
    assert fused_llama_decode.launches == before
    for got, want in zip(cache[:2], jcache[:2]):
        if int8_kv:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)


def test_candidates_from_beams():
    toks = np.array([[[5, 7, 9, 9], [9, 9, 9, 9]],
                     [[1, 2, 3, 4], [6, 9, 2, 9]]])
    want = np.asarray(jllama.candidates_from_beams(toks, 9))
    got = llama.candidates_from_beams(torch.from_numpy(toks), 9)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0].tolist() == [9, 5, 7, 9, -100]


def test_rescore_candidates(pair):
    jmodel, params, model = pair
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 128, (2, 3, 5))
    toks[0, 1, 2:] = 7
    cands = np.array(jllama.candidates_from_beams(toks, 7))
    scores = rng.standard_normal((2, 3)).astype(np.float32)
    prefix = rng.standard_normal((2, 2, 32)).astype(np.float32)
    jbest, jcomb = jllama.rescore_candidates(
        jmodel, params, jnp.asarray(cands), jnp.asarray(scores),
        prefix=jnp.asarray(prefix), alpha=0.3)
    best, comb = llama.rescore_candidates(
        model, torch.from_numpy(cands), torch.from_numpy(scores),
        prefix=torch.from_numpy(prefix), alpha=0.3)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jcomb), atol=1e-5)


def test_expand_cache_float_and_quant():
    rng = np.random.default_rng(5)
    k, v = (rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
            for _ in range(2))
    want = jllama.Llama.expand_cache((jnp.asarray(k), jnp.asarray(v)), 4)
    got = llama.Llama.expand_cache((torch.from_numpy(k),
                                    torch.from_numpy(v)), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jq = jllama.Llama.expand_cache(
        jgpt2.quantize_cache((jnp.asarray(k), jnp.asarray(v))), 4)
    tq = llama.Llama.expand_cache(
        gpt2.quantize_cache((torch.from_numpy(k), torch.from_numpy(v))), 4)
    assert isinstance(tq, gpt2.QuantCache)
    for g, w in zip(tq, jq):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_decode_weights_route_by_family(pair):
    """``sampling.decode_weights`` stacks K5's weights for a LLaMA and K2's
    for a GPT, in both weight modes."""
    model = pair[2]
    gpt = gpt2.GPT(tconfig.GPTConfig(block_size=16, vocab_size=64, n_layer=1,
                                     n_head=2, n_embd=32))
    for w8 in (False, True):
        lw = sampling.decode_weights(model, w8)
        gw = sampling.decode_weights(gpt, w8)
        assert set(fused_llama_decode.WEIGHT_KEYS) <= set(lw)
        assert "qkv_w" in gw and "wq" not in gw
        assert lw["wq"].shape == (2, 32, 32) and lw["wk"].shape == (2, 32, 16)
        assert (lw["wq"].dtype == torch.int8) == w8


@pytest.mark.parametrize("permute", [True, False])
def test_hf_import_reproduces_hf_logits(permute):
    """An HF checkpoint whose q/k projections are scaled by 25 (so the
    rotary convention matters): ``params_from_hf_llama`` gives HF's logits
    within 1e-4. Without its per-head q/k permutation (the HF names loaded
    as they are) the logits are far off."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=32, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for layer in hf.model.layers:
            layer.self_attn.q_proj.weight.mul_(25.0)
            layer.self_attn.k_proj.weight.mul_(25.0)
    sd = hf.state_dict()
    cfg, state = llama.params_from_hf_llama(sd, hf_cfg.to_dict())
    assert cfg.n_kv_heads == 2 and not cfg.tie_embeddings
    model = load_strict(llama.Llama(cfg), state if permute else {
        k: v for k, v in sd.items() if k in state})
    idx = torch.from_numpy(np.random.default_rng(6).integers(0, 96, (2, 7)))
    with torch.no_grad():
        want = hf(idx).logits
        _, got = model(idx, targets=idx)
    diff = float((got - want).abs().max())
    if permute:
        assert diff < 1e-4, diff
    else:
        assert diff > 1e-2, diff


def test_supported_rejects_what_k5_does_not_take():
    """On the card: E % 128 != 0, f32, H % KV != 0, and a cache too long
    for the scores' shared memory; FrankyLlama's LLaMA passes."""
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    ok = dict(e=1024, n_heads=16, n_kv_heads=8, f=2816, s=64)
    assert fused_llama_decode.supported("cuda", bf16, i8, i8, **ok)
    assert fused_llama_decode.supported("cuda", bf16, bf16, bf16, **ok)
    for bad in (dict(e=1000, n_heads=8), dict(n_kv_heads=6),
                dict(s=100_000)):
        assert not fused_llama_decode.supported("cuda", bf16, bf16, bf16,
                                                **dict(ok, **bad))
    assert not fused_llama_decode.supported("cuda", f32, f32, f32, **ok)
    assert fused_llama_decode.supported("cpu", f32, f32, f32, 32, 4, 2, 64,
                                        16)


def _llama_chain(model, int8_kv: bool, toks=None, steps: int = 3):
    """Prefill with a prefix, then ``steps`` decode steps (greedy, or the
    tokens ``toks``): (each step's logits, the tokens fed, the cache)."""
    rng = np.random.default_rng(4)
    idx0 = torch.from_numpy(rng.integers(0, 128, (2, 3)))
    prefix = torch.from_numpy(rng.standard_normal((2, 2, 32)).astype(
        np.float32))
    logits, cache, length = model.prefill(idx0, prefix,
                                          model.init_decode_cache(2, 16))
    if int8_kv:
        cache = gpt2.quantize_cache(cache)
    qw = sampling.decode_weights(model, int8_weights=False)
    out, fed = [], []
    for i in range(steps):
        tok = torch.argmax(logits, dim=-1) if toks is None else toks[i]
        logits, new, length = model.decode_step(tok, cache, length, qw)
        assert new[0] is cache[0] and new[1] is cache[1]
        cache = new
        out.append(logits)
        fed.append(tok)
    return out, fed, cache


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_decode_step_plain_route_matches_twin(pair, monkeypatch, kind):
    """With K5's gate shut ``decode_step`` runs the module blocks (the JAX
    package's scanned fallback; a ``QuantCache`` dequantized around them
    and requantized in place with its own scales), fed the twin's tokens:
    a bf16 model with a bf16 cache within 3e-2 of the twin's largest logit
    (bf16 rounding: the twin keeps an f32 residual), an f32 model with an
    int8 cache within 1e-4, code for code."""
    _, _, model = pair
    if kind == "bf16":
        model = copy.deepcopy(model).to(torch.bfloat16)
    int8_kv = kind == "int8"
    want, toks, want_cache = _llama_chain(model, int8_kv)
    monkeypatch.setattr(fused_llama_decode, "supported", lambda *a: False)
    calls = []
    real = fused_llama_decode.fused_llama_decode_blocks_ref
    monkeypatch.setattr(fused_llama_decode, "fused_llama_decode_blocks_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, _, cache = _llama_chain(model, int8_kv, toks)
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


def test_decode_step_plain_route_refuses_int8_weights(pair, monkeypatch):
    _, _, model = pair
    logits, cache, length = model.prefill(
        torch.zeros(2, 3, dtype=torch.long), None,
        model.init_decode_cache(2, 16))
    qw = sampling.decode_weights(model, int8_weights=True)
    monkeypatch.setattr(fused_llama_decode, "supported", lambda *a: False)
    with pytest.raises(NotImplementedError, match="K5"):
        model.decode_step(torch.argmax(logits, dim=-1), cache, length, qw)
