"""The port's Franky slice against the JAX package's, on a tiny geometry:
the ``_flagship(tiny=True)`` encoder and Perceiver, with a GPT of width 128
so the same model also drives kernel K2's twin. Weights go JAX ->
``export_franky`` -> ``load_strict``. float32 on both sides; on the
CPU the JAX package decodes with its scanned XLA blocks and the port with
K2's twin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.data import tokenizers as jtokenizers
from frankenstein_tpu.decode import pipeline as jpipeline
from frankenstein_tpu.decode import sampling as jsampling
from frankenstein_tpu.models import gpt2 as jgpt2
from frankenstein_tpu.models import llama as jllama
from frankenstein_tpu.models.franky import Franky as JFranky
from frankenstein_tpu.models.import_reference import export_franky
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
from frankenstein_tpu_torch.decode import pipeline, sampling
from frankenstein_tpu_torch.models import llama as tllama
from frankenstein_tpu_torch.models.franky import Franky
from frankenstein_tpu_torch.models.weights import (init_franky_,
                                                   llama_state_from_flax,
                                                   load_strict)
from frankenstein_tpu_torch.ops.cuda import (beam_reorder, fused_decode,
                                             fused_llama_decode,
                                             slab_attention)

torch.set_num_threads(1)

B, N_STEPS = 3, 6


def tiny_cfg(mod, **enc):
    return mod.FrankyConfig(
        brain=mod.PerceiverConfig(
            encoder=mod.MAEConfig(window_size=32, n_electrodes=8,
                                  patch_size=8, dim=16, n_layers=2,
                                  head_dim=8, hidden_dim=32, n_heads=2,
                                  n_kv_heads=2, n_dec_layers=1,
                                  decoder_dim=16, **enc),
            n_output_tokens=4, output_dim=128, dim=16, n_layers=1,
            head_dim=8, hidden_dim=32, n_heads=2, n_kv_heads=2),
        gpt=mod.GPTConfig(block_size=64, vocab_size=512, n_layer=2, n_head=4,
                          n_embd=128),
        max_tokens=8, pad_token_id=511)


@pytest.fixture(scope="module")
def pair():
    """(jax module, jax params, port model, seeded inputs)."""
    rng = np.random.default_rng(0)
    cfg = tiny_cfg(jconfig)
    jmodel = JFranky(cfg)
    x = rng.standard_normal((B, 32, 8)).astype(np.float32)
    y = rng.integers(0, 512, (B, 8)).astype(np.int32)
    y[:, -2:] = jconfig.IGNORE_INDEX
    params = jmodel.init(jax.random.key(0), jnp.asarray(x[:1]),
                         jnp.asarray(y[:1]))
    # perturb every leaf so zero-initialised biases and queries are tested
    params = jax.tree_util.tree_map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    model = load_strict(Franky(tiny_cfg(tconfig)), export_franky(params))
    return jmodel, params, model, x, y


def test_encode_prefix(pair):
    jmodel, params, model, x, _ = pair
    want = jmodel.apply(params, jnp.asarray(x), method=JFranky.encode)
    got = model.encode(torch.from_numpy(x))
    assert got.shape == (B, 4, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_forward_loss_and_logits(pair):
    jmodel, params, model, x, y = pair
    jloss, jlogits = jmodel.apply(params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        loss, logits = model(torch.from_numpy(x), torch.from_numpy(y).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-3)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-4)


def test_prefill_and_greedy_decode_logits(pair):
    """Prefill logits and every step of a 6-token greedy decode within 1e-3;
    the greedy tokens identical."""
    jmodel, params, model, x, _ = pair
    s = jsampling._round_cache_len(1 + 4 + N_STEPS + 1)
    assert sampling._round_cache_len(1 + 4 + N_STEPS + 1) == s
    jprefix = jmodel.apply(params, jnp.asarray(x), method=JFranky.encode)
    idx0 = np.full((B, 1), jconfig.GPT2_EOT % 512, np.int32)
    jcache = jgpt2.init_cache(jmodel.cfg.gpt, B, s)
    jlogits, jcache, jlen = jmodel.apply(params, jnp.asarray(idx0), jprefix,
                                         jcache, method=JFranky.prefill)
    prefix = model.encode(torch.from_numpy(x))
    cache = model.init_decode_cache(B, s)
    logits, cache, length = model.prefill(torch.from_numpy(idx0).long(),
                                          prefix, cache)
    assert length == int(jlen)
    qweights = sampling.decode_weights(model, int8_weights=False)
    for _ in range(N_STEPS):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-3)
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits, dim=-1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlogits, jcache, jlen = jmodel.apply(params, jtok, jcache, jlen,
                                             method=JFranky.decode_step)
        logits, cache, length = model.decode_step(tok, cache, length,
                                                  qweights)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-3)
    for got, want in zip(cache, jcache):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_generate_greedy_tokens(pair):
    jmodel, params, model, x, _ = pair
    jprefix = jmodel.apply(params, jnp.asarray(x), method=JFranky.encode)
    idx0 = np.full((B, 1), 7, np.int32)
    want = jsampling.generate(jmodel, params, jnp.asarray(idx0), jprefix,
                              jax.random.key(0), max_new_tokens=N_STEPS,
                              greedy=True)
    got = sampling.generate(model, torch.from_numpy(idx0).long(),
                            model.encode(torch.from_numpy(x)),
                            max_new_tokens=N_STEPS, greedy=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_predictor_w8a16_on_cpu(pair):
    """The predictor serves strings with w8a16 weights through the kernels'
    twins on the CPU, and counts no kernel launch."""
    _, _, model, x, _ = pair
    before = (slab_attention.launches, fused_decode.launches)
    predict = pipeline.make_franky_predictor(
        model, ByteTokenizer(), int8_weights=True, max_new_tokens=N_STEPS,
        eot_id=511)
    out = predict(x)
    assert len(out) == B and all(isinstance(s, str) for s in out)
    assert (slab_attention.launches, fused_decode.launches) == before


def test_topk_sampling_stays_in_topk(pair):
    """Sampled tokens come from the top-k of each step's logits."""
    _, _, model, x, _ = pair
    prefix = model.encode(torch.from_numpy(x))
    idx0 = torch.full((B, 1), 7, dtype=torch.long)
    cache = model.init_decode_cache(B, 16)
    logits, cache, length = model.prefill(idx0, prefix, cache)
    gen = torch.Generator().manual_seed(0)
    toks = sampling._sample_scan(
        model, logits, cache, length, gen,
        qweights=sampling.decode_weights(model, False), max_new_tokens=1,
        top_k=3)
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert all(int(toks[i, 0]) in top3[i].tolist() for i in range(B))


@pytest.mark.parametrize("kw", [{"beam_width": 4},
                                {"rescorer": "llama"},
                                {"int8_kv": True}])
def test_predictor_refuses_unported_flags(pair, kw):
    """No flag is refused any more. Beams and the int8 KV cache serve
    strings through the kernels' twins on the CPU, counting no kernel
    launch; Franky's beams rescored by a LLaMA (K5's twin) give the JAX
    predictor's strings."""
    jmodel, params, model, x, _ = pair
    if "rescorer" in kw:
        lcfg = dict(vocab_size=512, dim=32, n_layers=2, n_heads=4,
                    n_kv_heads=2, hidden_dim=64, max_seq_len=64)
        jlm = jllama.Llama(jllama.LlamaConfig(**lcfg))
        lparams = jlm.init(jax.random.key(1), jnp.zeros((1, 4), jnp.int32))
        lm = load_strict(tllama.Llama(tconfig.LlamaConfig(**lcfg)),
                         llama_state_from_flax(jax.tree_util.tree_map(
                             np.asarray, lparams["params"])))
        opts = dict(max_new_tokens=N_STEPS, eot_id=511, beam_width=3)
        want = jpipeline.make_franky_predictor(
            jmodel, params, jtokenizers.ByteTokenizer(eot_id=511),
            rescorer=(jlm, lparams, 0.7), **opts)(x)
        before = fused_llama_decode.launches
        got = pipeline.make_franky_predictor(
            model, ByteTokenizer(eot_id=511), rescorer=(lm, 0.7), **opts)(x)
        assert got == want and fused_llama_decode.launches == before
        return
    before = (slab_attention.launches, fused_decode.launches,
              beam_reorder.launches)
    predict = pipeline.make_franky_predictor(
        model, ByteTokenizer(), max_new_tokens=N_STEPS, eot_id=511, **kw)
    out = predict(x)
    assert len(out) == B and all(isinstance(s, str) for s in out)
    assert (slab_attention.launches, fused_decode.launches,
            beam_reorder.launches) == before


def test_seeded_init_is_finite_and_deterministic():
    a = init_franky_(Franky(tiny_cfg(tconfig)), seed=3)
    b = init_franky_(Franky(tiny_cfg(tconfig)), seed=3)
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.isfinite(pa).all(), name
        assert torch.equal(pa, pb), name
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 8)).astype(np.float32))
    assert torch.isfinite(a.encode(x)).all()
