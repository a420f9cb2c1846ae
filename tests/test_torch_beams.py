"""The port's beam search against the JAX package's, float32 on the CPU:
``beam_search`` (EOS, n-best, int8 KV), ``sampled_beam_search``,
``beam_from_prefill`` and the predictor's beam branch. Top-k is exact on
both sides off the TPU, so deterministic beams match token for token.
Weights go JAX -> ``export_gpt`` / ``export_franky`` -> the port."""

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
from frankenstein_tpu.models.franky import Franky as JFranky
from frankenstein_tpu.models.import_reference import export_franky, export_gpt
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
from frankenstein_tpu_torch.decode import pipeline, sampling
from frankenstein_tpu_torch.models import gpt2
from frankenstein_tpu_torch.models.franky import Franky
from frankenstein_tpu_torch.models.weights import load_strict

torch.set_num_threads(1)

B, W, STEPS = 3, 3, 6
GPT_KW = dict(block_size=32, vocab_size=96, n_layer=2, n_head=2, n_embd=32)


@pytest.fixture(scope="module")
def tiny_gpt():
    jmodel = jgpt2.GPT(jconfig.GPTConfig(**GPT_KW))
    idx0 = np.random.default_rng(9).integers(0, 96, (B, 4)).astype(np.int32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(idx0))
    model = load_strict(gpt2.GPT(tconfig.GPTConfig(**GPT_KW)),
                        export_gpt(params))
    # a token the best beams emit early, so EOS freezing is exercised
    toks, _ = jsampling.beam_search(jmodel, params, jnp.asarray(idx0), None,
                                    max_new_tokens=STEPS, beam_width=W)
    eos = int(toks[0, 1])
    return jmodel, params, model, idx0, eos


@pytest.mark.parametrize("opts", [
    {},
    {"eos": True, "length_penalty": 1.0},
    {"eos": True, "pad_id": 2, "length_penalty": 0.0},
    {"n_best": True, "eos": True, "length_penalty": 1.0},
    {"int8_kv": True},
    {"int8_kv": True, "eos": True, "length_penalty": 1.0, "n_best": True},
], ids=["plain", "eos", "eos-pad", "n_best", "int8_kv", "int8_kv-eos-n_best"])
def test_beam_search_matches_jax(tiny_gpt, opts):
    """Tokens identical, scores within 1e-4."""
    jmodel, params, model, idx0, eos = tiny_gpt
    kw = dict(opts)
    if kw.pop("eos", False):
        kw["eos_id"] = eos
    jt, js = jsampling.beam_search(jmodel, params, jnp.asarray(idx0), None,
                                   max_new_tokens=STEPS, beam_width=W, **kw)
    tt, ts = sampling.beam_search(model, torch.from_numpy(idx0).long(), None,
                                  max_new_tokens=STEPS, beam_width=W, **kw)
    want_shape = (B, W, STEPS) if kw.get("n_best") else (B, STEPS)
    assert tuple(tt.shape) == want_shape
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    if "eos_id" in kw and (kw.get("n_best") or not kw["length_penalty"]):
        assert (tt == eos).any()          # the EOS path did run


def test_beam_width_one_is_greedy(tiny_gpt):
    _, _, model, idx0, _ = tiny_gpt
    idx = torch.from_numpy(idx0).long()
    toks, _ = sampling.beam_search(model, idx, None, max_new_tokens=STEPS,
                                   beam_width=1)
    greedy = sampling.generate(model, idx, None, max_new_tokens=STEPS,
                               greedy=True)
    assert torch.equal(toks, greedy)


def test_sampled_beam_eos_freezes(tiny_gpt):
    """As ``tests/test_decode.py::test_sampled_beam_eos_freezes``: finite
    scores, and every row emits only the pad id after its first EOS."""
    _, _, model, idx0, eos = tiny_gpt
    pad = (eos + 3) % GPT_KW["vocab_size"]
    gen = torch.Generator().manual_seed(11)
    toks, scores = sampling.sampled_beam_search(
        model, torch.from_numpy(idx0).long(), None, gen, max_new_tokens=STEPS,
        beam_width=W, topk=8, eos_id=eos, pad_id=pad, length_penalty=1.0)
    assert toks.shape == (B, STEPS) and scores.shape == (B,)
    assert torch.isfinite(scores).all()
    for row in toks.numpy():
        stop = np.flatnonzero(row == eos)
        if len(stop):
            assert (row[stop[0] + 1:] == pad).all()
    nb, nbs = sampling.sampled_beam_search(
        model, torch.from_numpy(idx0).long(), None, gen, max_new_tokens=STEPS,
        beam_width=W, topk=8, n_best=True)
    assert nb.shape == (B, W, STEPS) and nbs.shape == (B, W)
    assert (nbs[:, :-1] >= nbs[:, 1:]).all()            # best first


class _ExpandGPT(gpt2.GPT):
    @staticmethod
    def expand_cache(cache, w):
        return tuple(c.repeat_interleave(w, dim=1) for c in cache)


def test_beam_from_prefill_equals_beam_search(tiny_gpt):
    """A batch-B prefill expanded to B*W beams decodes as the B*W prefill
    of ``beam_search``."""
    jmodel, params, _, idx0, eos = tiny_gpt
    model = load_strict(_ExpandGPT(tconfig.GPTConfig(**GPT_KW)),
                        export_gpt(params))
    idx = torch.from_numpy(idx0).long()
    logits, cache, length = sampling._prefill(model, idx, None, STEPS, False)
    got = sampling.beam_from_prefill(model, logits, cache, length,
                                     max_new_tokens=STEPS, beam_width=W,
                                     eos_id=eos)
    want = sampling.beam_search(model, idx, None, max_new_tokens=STEPS,
                                beam_width=W, eos_id=eos, length_penalty=1.0)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1])


class _BatchFirst:
    """A model without ``reorder_cache`` or ``expand_cache``, whose cache
    tensors hold the batch at axis 0 (the default layout of both)."""


def test_default_cache_layout_is_batch_first():
    cache = (torch.arange(6.).reshape(3, 2), [torch.arange(3)])
    logits, expanded = sampling._beam_expand(_BatchFirst(), torch.ones(3, 4),
                                             cache, 2)
    assert logits.shape == (6, 4)
    assert torch.equal(expanded[0], cache[0].repeat_interleave(2, dim=0))
    assert torch.equal(expanded[1][0], torch.tensor([0, 0, 1, 1, 2, 2]))
    picked = sampling._reorder(_BatchFirst(), expanded, torch.tensor(
        [1, 1, 2, 2, 5, 4]), group=2)
    assert torch.equal(picked[1][0], torch.tensor([0, 0, 1, 1, 2, 2]))
    assert torch.equal(picked[0][4], cache[0][2])


def _tiny_franky_cfg(mod):
    return mod.FrankyConfig(
        brain=mod.PerceiverConfig(
            encoder=mod.MAEConfig(window_size=32, n_electrodes=8,
                                  patch_size=8, dim=16, n_layers=2,
                                  head_dim=8, hidden_dim=32, n_heads=2,
                                  n_kv_heads=2, n_dec_layers=1,
                                  decoder_dim=16),
            n_output_tokens=4, output_dim=32, dim=16, n_layers=1,
            head_dim=8, hidden_dim=32, n_heads=2, n_kv_heads=2),
        gpt=mod.GPTConfig(block_size=32, vocab_size=300, n_layer=2, n_head=2,
                          n_embd=32),
        max_tokens=6, pad_token_id=299)


@pytest.fixture(scope="module")
def tiny_franky():
    rng = np.random.default_rng(5)
    jmodel = JFranky(_tiny_franky_cfg(jconfig))
    x = rng.standard_normal((2, 32, 8)).astype(np.float32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(x[:1]),
                         jnp.zeros((1, 6), jnp.int32))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    model = load_strict(Franky(_tiny_franky_cfg(tconfig)),
                        export_franky(params))
    return jmodel, params, model, x


@pytest.mark.parametrize("int8_kv", [False, True])
def test_predictor_beams_match_jax(tiny_franky, int8_kv):
    """``make_franky_predictor(beam_width=2)``, with a float or an int8 KV
    cache, returns the JAX predictor's strings."""
    jmodel, params, model, x = tiny_franky
    kw = dict(max_new_tokens=6, eot_id=299, beam_width=2, int8_kv=int8_kv)
    want = jpipeline.make_franky_predictor(
        jmodel, params, jtokenizers.ByteTokenizer(eot_id=299), **kw)(x)
    got = pipeline.make_franky_predictor(model, ByteTokenizer(eot_id=299),
                                         **kw)(x)
    assert len(got) == 2 and got == want
