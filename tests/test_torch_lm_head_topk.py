"""Kernel K8's plain twin (``ops/cuda/lm_head_topk.py``) against the JAX
package's ``lm_head_topk`` in Pallas interpret mode; ``GPT.decode_step_topk``
against the JAX ``GPT.decode_step_topk`` on weights through the bridge; the
sampler's compact route (``sampling.COMPACT_TOPK``): its tokens, and which
requests take it; K8's gate. float32 unless a case says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.decode import sampling as jsampling
from frankenstein_tpu.models import gpt2 as jgpt2
from frankenstein_tpu.models.import_reference import export_gpt
from frankenstein_tpu.ops.pallas import lm_head_topk as jk8
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
from frankenstein_tpu_torch.decode import pipeline, sampling
from frankenstein_tpu_torch.models import gpt2
from frankenstein_tpu_torch.models.franky import Franky, FrankyLlama
from frankenstein_tpu_torch.models.weights import (init_franky_,
                                                   init_franky_llama_,
                                                   load_strict)
from frankenstein_tpu_torch.ops.cuda import lm_head_topk

torch.set_num_threads(1)

B, E, V, CH = 8, 128, 512, 128
GPT_KW = dict(block_size=32, vocab_size=96, n_layer=2, n_head=2, n_embd=32)


def _inputs(seed=0):
    """x [B, E], ln_w, ln_b [E] and the table [V, E] (the JAX test's
    scales), as numpy f32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, E)).astype(np.float32),
            (rng.standard_normal(E) * 0.1 + 1).astype(np.float32),
            (rng.standard_normal(E) * 0.1).astype(np.float32),
            (rng.standard_normal((V, E)) * 0.05).astype(np.float32))


def _jax_topk(x, ln_w, ln_b, wte, k, dtype):
    """The JAX kernel's candidates, reduced to the top-k as
    ``GPT.decode_step_topk`` does (``lax.top_k``: ties to the lower
    position, and candidates are in vocab order within and across chunks)."""
    vals, idx, logz = jk8.lm_head_topk(
        jnp.asarray(x), jnp.asarray(ln_w), jnp.asarray(ln_b),
        jnp.asarray(wte.T).astype(dtype), k=k, chunk=CH, interpret=True)
    top, pos = jax.lax.top_k(vals, k)
    return (np.asarray(top), np.asarray(jnp.take_along_axis(idx, pos, 1)),
            np.asarray(logz))


def _port(x, ln_w, ln_b, wte, k, dtype):
    t = lambda a: torch.from_numpy(a)
    return lm_head_topk.lm_head_topk(t(x), t(ln_w), t(ln_b),
                                     t(wte).to(dtype), k=k)


@pytest.mark.parametrize("table", ["float32", "bfloat16"])
def test_twin_matches_pallas_kernel_interpret(table):
    """vals and logz within 1e-5, idx equal; the bf16 table rounds h to
    bf16 on both sides (the JAX kernel's ``h.astype(w_ref.dtype)``)."""
    x, ln_w, ln_b, wte = _inputs()
    jv, ji, jz = _jax_topk(x, ln_w, ln_b, wte, 5, getattr(jnp, table))
    before = lm_head_topk.launches
    tv, ti, tz = _port(x, ln_w, ln_b, wte, 5, getattr(torch, table))
    assert lm_head_topk.launches == before
    assert tv.dtype == tz.dtype == torch.float32 and ti.dtype == torch.int64
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tz.numpy(), jz, rtol=1e-5, atol=1e-5)


def test_duplicate_columns_break_ties_to_the_lower_index():
    """Vocab rows 3, 7 (one JAX chunk) and 130 (the next) equal and aligned
    with every row's h, so they are each row's top three at equal values:
    (3, 7, 130) in that order, as the JAX kernel's candidates give them."""
    x, ln_w, ln_b, wte = _inputs(2)
    x[:] = x[0]
    h0 = (x[0] - x[0].mean()) / np.sqrt(x[0].var() + 1e-5) * ln_w + ln_b
    wte[3] = wte[7] = wte[130] = 0.2 * h0
    jv, ji, _ = _jax_topk(x, ln_w, ln_b, wte, 4, jnp.float32)
    tv, ti, _ = _port(x, ln_w, ln_b, wte, 4, torch.float32)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=1e-5)
    assert (ti[:, :3] == torch.tensor([3, 7, 130])).all()
    assert (tv[:, 0] == tv[:, 1]).all() and (tv[:, 1] == tv[:, 2]).all()
    assert all(len(set(row.tolist())) == 4 for row in ti)


def test_exact_topk_orders_ties_by_index():
    logits = torch.tensor([[1.0, 3.0, 2.0, 3.0, 3.0, 0.5]])
    vals, idx = lm_head_topk.exact_topk(logits, 4)
    assert idx.tolist() == [[1, 3, 4, 2]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]


@pytest.fixture(scope="module")
def tiny_gpt():
    jmodel = jgpt2.GPT(jconfig.GPTConfig(**GPT_KW))
    idx0 = np.random.default_rng(9).integers(0, 96, (3, 4)).astype(np.int32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(idx0))
    model = load_strict(gpt2.GPT(tconfig.GPTConfig(**GPT_KW)),
                        export_gpt(params))
    return jmodel, params, model, idx0


@pytest.mark.parametrize("int8_kv", [False, True])
def test_decode_step_topk_matches_jax(tiny_gpt, int8_kv):
    """Two chained steps from one prefill: vals and logz within 1e-5, idx
    equal, the cache row each step writes within 1e-5 (int8 codes equal),
    and the length advanced."""
    jmodel, params, model, idx0 = tiny_gpt
    max_len = jsampling._round_cache_len(idx0.shape[1] + 3)
    _, jcache, jlen = jsampling._prefill_args(jmodel, params,
                                              jnp.asarray(idx0), None,
                                              max_len)
    _, tcache, tlen = model.prefill(torch.from_numpy(idx0).long(), None,
                                    model.init_decode_cache(3, max_len))
    if int8_kv:
        jcache, tcache = jgpt2.quantize_cache(jcache), gpt2.quantize_cache(
            tcache)
    tok = np.asarray([3, 5, 7], np.int32)
    for _ in range(2):
        jv, ji, jz, jcache, jlen2 = jmodel.apply(
            params, jnp.asarray(tok), jcache, jlen, k=4,
            method=jgpt2.GPT.decode_step_topk)
        tv, ti, tz, tcache, tlen2 = model.decode_step_topk(
            torch.from_numpy(tok).long(), tcache, tlen, k=4)
        assert tlen2 == int(jlen2) == tlen + 1
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5)
        for side in range(2):
            got = tcache[side][:, :, tlen].numpy()
            want = np.asarray(jcache[side])[:, :, tlen]
            if int8_kv:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, atol=1e-5)
        tok, tlen, jlen = ti[:, 0].numpy().astype(np.int32), tlen2, jlen2


def test_decode_step_topk_plain_route_when_the_gate_says_no(tiny_gpt,
                                                            monkeypatch):
    """With K8's gate shut the step runs ln_f + the dense head +
    ``exact_topk`` and never the twin: the same top-k as the dense
    ``decode_step``'s logits, and their logsumexp."""
    _, _, model, idx0 = tiny_gpt
    calls = []
    real = lm_head_topk.lm_head_topk_ref
    monkeypatch.setattr(lm_head_topk, "supported", lambda *a: False)
    monkeypatch.setattr(lm_head_topk, "lm_head_topk_ref",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    idx = torch.from_numpy(idx0).long()
    _, cache, length = model.prefill(idx, None, model.init_decode_cache(3, 16))
    dense_cache = tuple(c.clone() for c in cache)
    tok = torch.tensor([1, 2, 3])
    vals, ti, logz, _, _ = model.decode_step_topk(tok, cache, length, k=6)
    logits, _, _ = model.decode_step(tok, dense_cache, length)
    want_v, want_i = lm_head_topk.exact_topk(logits, 6)
    assert not calls
    assert torch.equal(vals, want_v) and torch.equal(ti, want_i)
    assert torch.equal(logz, torch.logsumexp(logits, dim=-1))


def test_decode_step_topk_refuses_int8_weights(tiny_gpt):
    _, _, model, idx0 = tiny_gpt
    idx = torch.from_numpy(idx0).long()
    _, cache, length = model.prefill(idx, None, model.init_decode_cache(3, 16))
    qw = gpt2.quantize_decode_weights(model, torch.float32)
    with pytest.raises(NotImplementedError, match="int8"):
        model.decode_step_topk(torch.tensor([1, 2, 3]), cache, length, qw,
                               k=4)


def _tiny_franky_cfg(**gpt):
    return tconfig.FrankyConfig(
        brain=tconfig.PerceiverConfig(
            encoder=tconfig.MAEConfig(window_size=32, n_electrodes=8,
                                      patch_size=8, dim=16, n_layers=1,
                                      head_dim=8, hidden_dim=32, n_heads=2,
                                      n_kv_heads=2, n_dec_layers=1,
                                      decoder_dim=16),
            n_output_tokens=4, output_dim=64, dim=16, n_layers=1,
            head_dim=8, hidden_dim=32, n_heads=2, n_kv_heads=2),
        gpt=tconfig.GPTConfig(block_size=64, vocab_size=300, n_layer=2,
                              n_head=2, n_embd=64, **gpt),
        max_tokens=8, pad_token_id=299)


@pytest.fixture
def topk_calls(monkeypatch):
    """Counts ``GPT.decode_step_topk`` calls (Franky delegates to it)."""
    calls = []
    real = gpt2.GPT.decode_step_topk
    monkeypatch.setattr(gpt2.GPT, "decode_step_topk",
                        lambda self, *a, **k: (calls.append(1),
                                               real(self, *a, **k))[1])
    return calls


def _predict(model, compact, monkeypatch, **kw):
    monkeypatch.setattr(sampling, "COMPACT_TOPK", compact)
    x = np.random.default_rng(4).standard_normal((3, 32, 8)).astype(
        np.float32)
    return pipeline.make_franky_predictor(
        model, ByteTokenizer(eot_id=299), max_new_tokens=6, eot_id=299,
        seed=5, **kw)(x)


@pytest.mark.parametrize("int8_kv", [False, True])
def test_compact_route_gives_the_dense_route_tokens(monkeypatch, topk_calls,
                                                    int8_kv):
    """A Franky top-k request, ``COMPACT_TOPK`` on and off, one seed: the
    same strings; on, one ``decode_step_topk`` per token and no dense
    ``decode_step``; off, none."""
    model = init_franky_(Franky(_tiny_franky_cfg()), seed=1)
    dense_steps = []
    real = gpt2.GPT.decode_step
    monkeypatch.setattr(gpt2.GPT, "decode_step",
                        lambda self, *a, **k: (dense_steps.append(1),
                                               real(self, *a, **k))[1])
    on = _predict(model, True, monkeypatch, top_k=10, int8_kv=int8_kv)
    assert (len(topk_calls), len(dense_steps)) == (6, 0)
    off = _predict(model, False, monkeypatch, top_k=10, int8_kv=int8_kv)
    assert (len(topk_calls), len(dense_steps)) == (6, 6)
    assert on == off and len(on) == 3


@pytest.mark.parametrize("request_kw", [
    {"top_k": 10, "int8_weights": True},
    {"top_k": None},
    {"top_k": 400},
    {"top_k": 10, "beam_width": 2},
], ids=["w8a16", "no-top-k", "top-k-past-vocab", "beams"])
def test_requests_that_keep_the_dense_route(monkeypatch, topk_calls,
                                            request_kw):
    model = init_franky_(Franky(_tiny_franky_cfg()), seed=1)
    out = _predict(model, True, monkeypatch, **request_kw)
    assert len(out) == 3 and not topk_calls


def test_greedy_keeps_the_dense_route(monkeypatch, topk_calls):
    monkeypatch.setattr(sampling, "COMPACT_TOPK", True)
    model = init_franky_(Franky(_tiny_franky_cfg()), seed=1)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 32, 8)).astype(np.float32))
    idx0 = torch.full((2, 1), 299, dtype=torch.long)
    toks = sampling.generate(model, idx0, model.encode(x), max_new_tokens=4,
                             top_k=10, greedy=True)
    assert toks.shape == (2, 4) and not topk_calls


def test_franky_llama_keeps_the_dense_route(monkeypatch, topk_calls):
    """The JAX FrankyLlama has no decode_step_topk, so neither has the
    port's: its top-k requests decode densely with the switch on."""
    assert not hasattr(FrankyLlama, "decode_step_topk")
    lm = tconfig.tiny_llama_config(vocab_size=300)
    base = _tiny_franky_cfg()
    cfg = tconfig.FrankyLlamaConfig(
        brain=tconfig.PerceiverConfig(
            encoder=base.brain.encoder, n_output_tokens=4, output_dim=lm.dim,
            dim=16, n_layers=1, head_dim=8, hidden_dim=32, n_heads=2,
            n_kv_heads=2),
        lm=lm, max_tokens=8, pad_token_id=299)
    model = init_franky_llama_(FrankyLlama(cfg), seed=2)
    out = _predict(model, True, monkeypatch, top_k=10)
    assert len(out) == 3 and not topk_calls


def test_supported_gate():
    """On the card: bf16 x and table, E % 8 == 0 at any width (the table
    is streamed: GPT-2's 768 to GPT-2 XL's 1600 and past), 1 <= k <= 32,
    k <= V, any B and any V (a ragged tail is masked); the CPU twin takes
    anything."""
    bf16, f32 = torch.bfloat16, torch.float32
    cuda = torch.device("cuda")
    assert lm_head_topk.supported(cuda, bf16, bf16, 128, 768, 50304, 10)
    assert lm_head_topk.supported(cuda, bf16, bf16, 1, 768, 50257, 32)
    assert lm_head_topk.supported(cuda, bf16, bf16, 160, 1024, 50304, 1)
    assert lm_head_topk.supported(cuda, bf16, bf16, 300, 1600, 50257, 32)
    assert not lm_head_topk.supported(cuda, f32, f32, 128, 768, 50304, 10)
    assert not lm_head_topk.supported(cuda, bf16, f32, 128, 768, 50304, 10)
    assert not lm_head_topk.supported(cuda, bf16, bf16, 128, 768, 50304, 33)
    assert not lm_head_topk.supported(cuda, bf16, bf16, 128, 768, 50304, 0)
    assert not lm_head_topk.supported(cuda, bf16, bf16, 128, 770, 50304, 10)
    assert not lm_head_topk.supported(cuda, bf16, bf16, 8, 768, 5, 10)
    assert lm_head_topk.supported(torch.device("cpu"), f32, f32, 3, 7, 5, 40)


def test_plan_fits_shared_memory():
    """The instance a batch takes (B rounded up to a width, chunks of 128
    beyond) fits a CTA's shared memory with a ring of at least two stages
    at every k, as many as fit up to eight: four at the flagship's B=128,
    three at k=32 on the widest grid."""
    assert lm_head_topk._plan(1, 10)[:2] == (8, 8)
    assert lm_head_topk._plan(128, 10)[:2] == (128, 4)
    assert lm_head_topk._plan(160, 10)[:2] == (128, 4)
    assert lm_head_topk._plan(128, 32, 256)[:2] == (128, 3)
    assert lm_head_topk._plan(300, 10)[0] == 128
    for b in lm_head_topk.WIDTHS:
        for k in (1, 10, 32):
            n, st, smem = lm_head_topk._plan(b, k, lm_head_topk.MAX_GRID)
            assert n == b and st >= 2 and smem <= lm_head_topk.SMEM_MAX
