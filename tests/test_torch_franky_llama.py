"""The port's FrankyLlama against the JAX package's, float32 on the CPU, on
the tiny composite of ``tests/test_franky_llama.py``: the weight bridge
(``export_brain_encoder`` + ``llama_state_from_flax`` -> ``load_strict``,
strict), the encode prefix, greedy decode, n-best beams with and without an
int8 KV cache, self-rescoring, and the predictor with ``rescorer=``. (A
Franky's beams rescored by a plain ``Llama`` are in
``test_torch_franky.py``.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.data import tokenizers as jtokenizers
from frankenstein_tpu.decode import pipeline as jpipeline
from frankenstein_tpu.decode import sampling as jsampling
from frankenstein_tpu.models import llama as jllama
from frankenstein_tpu.models.franky import FrankyLlama as JFrankyLlama
from frankenstein_tpu.models.franky import \
    FrankyLlamaConfig as JFrankyLlamaConfig
from frankenstein_tpu.models.import_reference import export_brain_encoder
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
from frankenstein_tpu_torch.decode import pipeline, sampling
from frankenstein_tpu_torch.eval.evaluate import evaluate_franky_wer
from frankenstein_tpu_torch.models import llama
from frankenstein_tpu_torch.models.franky import FrankyLlama
from frankenstein_tpu_torch.models.weights import (init_franky_llama_,
                                                   llama_state_from_flax,
                                                   load_strict)
from frankenstein_tpu_torch.ops.cuda import (beam_reorder,
                                             fused_llama_decode,
                                             slab_attention)

torch.set_num_threads(1)

EOT, B, STEPS = 299, 2, 5


def tiny_cfg(mod, cls):
    lm = mod.tiny_llama_config(vocab_size=300)
    c = jconfig if mod is jllama else tconfig
    return cls(
        brain=c.PerceiverConfig(
            encoder=c.MAEConfig(window_size=32, n_electrodes=8, patch_size=8,
                                dim=16, n_layers=1, head_dim=8,
                                hidden_dim=32, n_heads=2, n_kv_heads=2,
                                n_dec_layers=1, decoder_dim=16),
            n_output_tokens=4, output_dim=lm.dim, dim=16, n_layers=1,
            head_dim=8, hidden_dim=32, n_heads=2, n_kv_heads=2),
        lm=lm, max_tokens=8, pad_token_id=EOT)


def export_franky_llama(params) -> dict:
    """The JAX FrankyLlama's params as the port's state dict."""
    p = jax.tree_util.tree_map(np.asarray, params["params"])
    out = export_brain_encoder({"params": p["brain_model"]},
                               prefix="brain_model.")
    out.update(llama_state_from_flax(p["llm_model"], prefix="llm_model."))
    return out


@pytest.fixture(scope="module")
def pair():
    """(jax module, jax params, port model, seeded windows)."""
    jmodel = JFrankyLlama(tiny_cfg(jllama, JFrankyLlamaConfig))
    rng = np.random.default_rng(0)
    params = jmodel.init(jax.random.key(0), jnp.ones((1, 32, 8)),
                         jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    model = load_strict(
        FrankyLlama(tiny_cfg(tconfig, tconfig.FrankyLlamaConfig)),
        export_franky_llama(params))
    x = rng.standard_normal((B, 32, 8)).astype(np.float32)
    return jmodel, params, model, x


def test_weight_bridge_is_strict(pair):
    model = pair[2]
    state = export_franky_llama(pair[1])
    assert set(state) == set(model.state_dict())
    state.pop("llm_model.model.norm.weight")
    with pytest.raises(RuntimeError, match="Missing"):
        load_strict(FrankyLlama(tiny_cfg(tconfig,
                                               tconfig.FrankyLlamaConfig)),
                          state)


def test_encode_prefix_and_forward(pair):
    jmodel, params, model, x = pair
    want = jmodel.apply(params, jnp.asarray(x), method=JFrankyLlama.encode)
    got = model.encode(torch.from_numpy(x))
    assert got.shape == (B, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    y = np.random.default_rng(1).integers(0, 300, (B, 8))
    y[:, 6:] = -100
    jloss, jlogits = jmodel.apply(params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        loss, logits = model(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-4)


def test_greedy_generate_tokens(pair):
    jmodel, params, model, x = pair
    jprefix = jmodel.apply(params, jnp.asarray(x), method=JFrankyLlama.encode)
    idx0 = np.full((B, 1), EOT, np.int32)
    want = jsampling.generate(jmodel, params, jnp.asarray(idx0), jprefix,
                              jax.random.key(0), max_new_tokens=STEPS,
                              greedy=True)
    got = sampling.generate(model, torch.from_numpy(idx0).long(),
                            model.encode(torch.from_numpy(x)),
                            max_new_tokens=STEPS, greedy=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("int8_kv", [False, True])
def test_n_best_beams_and_self_rescoring(pair, int8_kv):
    """n-best beams: tokens identical, scores within 1e-4; the composite's
    brain-conditioned rescoring of them picks the same beams."""
    jmodel, params, model, x = pair
    jprefix = jmodel.apply(params, jnp.asarray(x), method=JFrankyLlama.encode)
    prefix = model.encode(torch.from_numpy(x))
    idx0 = np.full((B, 1), EOT, np.int32)
    kw = dict(max_new_tokens=STEPS, beam_width=3, eos_id=EOT,
              length_penalty=1.0, n_best=True, int8_kv=int8_kv)
    jtoks, jscores = jsampling.beam_search(jmodel, params, jnp.asarray(idx0),
                                           jprefix, **kw)
    toks, scores = sampling.beam_search(model, torch.from_numpy(idx0).long(),
                                        prefix, **kw)
    assert toks.shape == (B, 3, STEPS)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=1e-4)

    jbest, jcomb = jllama.rescore_candidates(
        jmodel, params, jllama.candidates_from_beams(jtoks, EOT),
        decoder_scores=jscores, prefix=jprefix, alpha=0.5)
    best, comb = llama.rescore_candidates(
        model, llama.candidates_from_beams(toks, EOT), decoder_scores=scores,
        prefix=prefix, alpha=0.5)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jcomb), atol=1e-4)


@pytest.mark.parametrize("int8_kv", [False, True])
def test_predictor_with_rescorer_matches_jax(pair, int8_kv):
    """``make_franky_predictor(beam_width=3, rescorer=(fl,))`` gives the
    JAX predictor's strings with ``rescorer=(fl, params)``, and counts no
    kernel launch on the CPU."""
    jmodel, params, model, x = pair
    kw = dict(max_new_tokens=STEPS, beam_width=3, eot_id=EOT,
              int8_kv=int8_kv)
    want = jpipeline.make_franky_predictor(
        jmodel, params, jtokenizers.ByteTokenizer(eot_id=EOT),
        rescorer=(jmodel, params), **kw)(x)
    before = (slab_attention.launches, fused_llama_decode.launches,
              beam_reorder.launches)
    got = pipeline.make_franky_predictor(model, ByteTokenizer(eot_id=EOT),
                                         rescorer=(model,), **kw)(x)
    assert got == want
    assert (slab_attention.launches, fused_llama_decode.launches,
            beam_reorder.launches) == before


def test_topk_predictor_and_wer_eval_serve(pair):
    """The top-k branch and ``evaluate_franky_wer(rescorer=...)`` serve
    strings for FrankyLlama on the CPU."""
    model, x = pair[2], pair[3]
    out = pipeline.make_franky_predictor(
        model, ByteTokenizer(eot_id=EOT), max_new_tokens=STEPS,
        eot_id=EOT, int8_weights=True)(x)
    assert len(out) == B and all(isinstance(s, str) for s in out)

    class Trials:
        targets = ["a b", "c", "d e f"]

        def __len__(self):
            return 3

        def __getitem__(self, i):
            return x[i % B], None

    wer, preds = evaluate_franky_wer(model, Trials(), ByteTokenizer(
        eot_id=EOT), batch_size=2, max_new_tokens=STEPS, beam_width=2,
        eot_id=EOT, rescorer=(model, 0.3))
    assert len(preds) == 3 and np.isfinite(wer)


def test_seeded_init_is_finite_and_deterministic():
    cfg = tiny_cfg(tconfig, tconfig.FrankyLlamaConfig)
    a = init_franky_llama_(FrankyLlama(cfg), seed=3)
    b = init_franky_llama_(FrankyLlama(cfg), seed=3)
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.isfinite(pa).all(), name
        assert torch.equal(pa, pb), name
    norm = a.llm_model.model.norm.weight
    assert torch.equal(norm, torch.ones_like(norm))
    q = a.llm_model.model.layers[0].self_attn.q_proj.weight.detach()
    assert abs(float(q.std()) - 0.02) < 5e-3


def test_output_dim_must_match_lm_dim():
    cfg = tiny_cfg(tconfig, tconfig.FrankyLlamaConfig)
    bad = cfg.replace(brain=cfg.brain.replace(output_dim=16))
    with pytest.raises(ValueError, match="output_dim"):
        FrankyLlama(bad)
