"""The whisper path's serving and training entry points on the CPU:
``evaluate_seq2seq_wer`` against the JAX package's (the same WER and the
same strings, greedy, with beams and over int8 KV), the HF importer against
a random ``transformers`` Whisper built from a config (no download), and
the fine-tuning pipeline (``python -m
frankenstein_tpu_torch.whisper_pipeline``) at a tiny size, with its
refusals. The JAX weights come across by
``whisper_state_from_flax``; inputs from numpy seeds."""

import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.data.tokenizers import ByteTokenizer as JByteTokenizer
from frankenstein_tpu.eval import evaluate as jevaluate
from frankenstein_tpu.models import whisper as jwhisper
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch import whisper_pipeline
from frankenstein_tpu_torch.data import tokenizers
from frankenstein_tpu_torch.eval.evaluate import evaluate_seq2seq_wer
from frankenstein_tpu_torch.models import whisper
from frankenstein_tpu_torch.models.weights import (load_strict,
                                                   whisper_state_from_flax)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HF_TOL = 3e-4      # f32 logits against HF's (tests/test_whisper.py)

# tests/test_whisper.py:tiny_cfg()
TINY = dict(n_mels=8, n_audio_ctx=16, n_audio_state=16, n_audio_head=2,
            n_audio_layer=2, n_vocab=64, n_text_ctx=16, n_text_state=16,
            n_text_head=2, n_text_layer=2)
SENTENCES = ["a b", "i want to go", "c", "the day", "good people",
             "help me"]


@pytest.fixture(scope="module")
def pair():
    jm = jwhisper.BrainWhisper(jconfig.WhisperConfig(**TINY))
    params = jax.jit(jm.init)(jax.random.key(3),
                              jnp.zeros((2, TINY["n_mels"], 32)),
                              jnp.zeros((2, 6), jnp.int32))
    tm = load_strict(whisper.BrainWhisper(tconfig.WhisperConfig(**TINY)),
                     whisper_state_from_flax(jax.tree_util.tree_map(
                         np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("kw", [
    {}, {"beam_width": 3}, {"beam_width": 3, "length_penalty": 0.0},
    {"int8_kv": True}, {"beam_width": 3, "int8_kv": True},
    {"start_id": 5, "eot_id": 9}], ids=["greedy", "beams", "beams-lp0",
                                        "greedy-int8", "beams-int8",
                                        "start-id"])
def test_seq2seq_wer_matches_jax(pair, kw):
    """Six inputs at batch 4 (the last batch padded): the same predicted
    strings and corpus WER as the JAX package's. The byte tokenizer's end
    token is the model's, so rows are cut where the model emits it."""
    jm, params, tm = pair
    mels = np.random.default_rng(9).standard_normal(
        (6, TINY["n_mels"], 32)).astype(np.float32)
    eot = kw.get("eot_id", tm.eot_id())
    common = dict(batch_size=4, max_new_tokens=5, **kw)
    jwer, jpreds = jevaluate.evaluate_seq2seq_wer(
        jm, params, mels, SENTENCES, JByteTokenizer(eot_id=eot), **common)
    wer, preds = evaluate_seq2seq_wer(
        tm, mels, SENTENCES, tokenizers.ByteTokenizer(eot_id=eot), **common)
    assert len(preds) == 6
    assert preds == jpreds
    assert wer == jwer


def _hf(seed):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.WhisperConfig(
        vocab_size=64, num_mel_bins=8, d_model=16, encoder_layers=2,
        encoder_attention_heads=2, decoder_layers=2,
        decoder_attention_heads=2, decoder_ffn_dim=64, encoder_ffn_dim=64,
        max_source_positions=16, max_target_positions=16, pad_token_id=0,
        bos_token_id=1, eos_token_id=2, decoder_start_token_id=3)
    torch.manual_seed(seed)
    hf = transformers.WhisperForConditionalGeneration(cfg).eval()
    hf.generation_config.forced_decoder_ids = [(1, 5), (2, 7)]
    return hf


def test_hf_import_matches_hf_logits_and_the_jax_import():
    """A random HF Whisper: the imported port model gives HF's logits
    within HF_TOL; the special tokens and the prompt come from its config
    and ``forced_decoder_ids``; the state is the JAX importer's flax tree
    carried back by ``whisper_state_from_flax`` (the inverse mapping), less
    the encoder position table both drop."""
    hf = _hf(0)
    state, cfg = whisper.params_from_hf_whisper(hf)
    assert (cfg.decoder_start_token_id, cfg.eos_token_id, cfg.pad_token) \
        == (3, 2, 0)
    assert cfg.sot_sequence == (3, 5, 7)
    model = load_strict(whisper.BrainWhisper(cfg), state)
    assert model.sot_prompt() == (3, 5, 7)
    assert (model.sot_id(), model.eot_id(), model.pad_id()) == (3, 2, 0)
    assert "model.encoder.embed_positions.weight" not in state
    np.testing.assert_allclose(
        model.model["encoder"].positions.numpy(),
        hf.state_dict()["model.encoder.embed_positions.weight"].numpy(),
        atol=1e-6)

    rng = np.random.default_rng(2)
    mel = rng.standard_normal((2, 8, 32)).astype(np.float32)
    ids = rng.integers(0, 64, (2, 5))
    with torch.no_grad():
        want = hf(input_features=torch.from_numpy(mel),
                  decoder_input_ids=torch.from_numpy(ids)).logits.numpy()
        got = model(torch.from_numpy(mel),
                    decoder_input_ids=torch.from_numpy(ids))[1].numpy()
    np.testing.assert_allclose(got, want, atol=HF_TOL)

    jparams, jcfg = jwhisper.params_from_hf_whisper(hf)
    assert jcfg.to_dict() == cfg.to_dict()
    back = whisper_state_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    assert set(back) == set(state)
    for name in state:
        np.testing.assert_array_equal(back[name], state[name], err_msg=name)


def test_hf_prompted_greedy_matches_hf_generate():
    """Greedy from the imported model's full prompt equals HF's
    ``generate()`` token for token."""
    hf = _hf(1)
    hf.generation_config.begin_suppress_tokens = None
    hf.generation_config.suppress_tokens = None
    state, cfg = whisper.params_from_hf_whisper(hf)
    model = load_strict(whisper.BrainWhisper(cfg), state)
    mel = np.random.default_rng(5).standard_normal((2, 8, 32)).astype(
        np.float32)
    with torch.no_grad():
        ref = hf.generate(input_features=torch.from_numpy(mel),
                          max_new_tokens=5, do_sample=False,
                          num_beams=1).numpy()
    from frankenstein_tpu_torch.decode import sampling
    prompt = model.sot_prompt()
    logits, cache, length = model.prefill(
        torch.tensor(prompt).repeat(2, 1), torch.from_numpy(mel),
        whisper.init_whisper_cache(cfg, 2, 16))
    got = sampling.greedy_decode_scan(model, logits, cache, length,
                                      max_new_tokens=5).numpy()
    tail = ref[:, len(prompt):len(prompt) + 5]
    np.testing.assert_array_equal(got[:, :tail.shape[1]], tail)


def _tiny_build(monkeypatch):
    """``whisper_pipeline.build`` at a tiny geometry (vocabulary 300 for
    the byte tokenizer's ids, 48 positions for the 32-token labels), an
    eval every 2 steps, on the byte tokenizer."""
    monkeypatch.setattr(tokenizers, "best_available_tokenizer",
                        lambda: tokenizers.ByteTokenizer())
    cfg = tconfig.WhisperConfig(**dict(TINY, n_vocab=300, n_text_ctx=48))
    monkeypatch.setattr(whisper_pipeline, "build", functools.partial(
        whisper_pipeline.build, cfg=cfg, eval_interval=2))


def test_pipeline_trains_on_the_cpu_when_asked(monkeypatch, tmp_path):
    """The CLI's main with ``--device cpu`` at a tiny size: 2 steps, one
    eval with a WER, metrics.jsonl and a checkpoint."""
    _tiny_build(monkeypatch)
    state = whisper_pipeline.main([
        "--device", "cpu", "--steps", "2", "--batch-size", "4",
        "--save-folder", str(tmp_path)])
    run = tmp_path / "whisper_brain"
    assert state.step == 2
    records = [json.loads(line) for line in
               (run / "metrics.jsonl").read_text().splitlines()]
    wer = [r["val/metric"] for r in records if "val/metric" in r]
    assert len(wer) == 1 and np.isfinite(wer[0])
    assert any(np.isfinite(r["val/loss"]) for r in records
               if "val/loss" in r)
    assert list(run.glob("step_*"))
    assert json.loads((run / "train_config.json").read_text())[
        "warmup_iters"] == 128 // 4


def test_pipeline_build_geometry(monkeypatch):
    """The prep follows the config: n_mels components, 2 * n_audio_ctx
    frames; labels cut to 30 ids and padded with -100 to 32; bf16
    compute."""
    _tiny_build(monkeypatch)
    pipe = whisper_pipeline.build(device="cpu", batch_size=4, steps=3)
    train, val = pipe.datasets
    mel, labels, date = train[0]
    assert mel.shape == (8, 32) and mel.dtype == np.float32
    assert labels.shape == (32,) and labels.dtype == np.int64 and date == 0
    assert len(train) == 128 and len(val) == 32
    assert pipe.model.compute_dtype == torch.bfloat16
    assert pipe.config.max_steps == 3 and pipe.config.learning_rate == 2.5e-5


def test_cli_needs_a_gpu_unless_asked_for_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "frankenstein_tpu_torch.whisper_pipeline",
         "--steps", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr


def test_hf_whisper_without_transformers_exits_with_the_cause(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit, match="transformers"):
        whisper_pipeline.build(device="cpu", hf_whisper="/nonexistent")
