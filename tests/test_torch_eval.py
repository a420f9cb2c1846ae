"""The port's framework-free copies (``data/text.py``, ``data/datasets.py``,
``data/tokenizers.py``, ``eval/wer.py``, ``eval/submission.py``) held to the
JAX package's originals, and ``evaluate_franky_wer`` against the JAX
package's on a tiny Franky with beams (float32, CPU)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.data import datasets as jdatasets
from frankenstein_tpu.data import native as jnative
from frankenstein_tpu.data import text as jtext
from frankenstein_tpu.data import tokenizers as jtokenizers
from frankenstein_tpu.eval import evaluate as jevaluate
from frankenstein_tpu.eval import submission as jsubmission
from frankenstein_tpu.eval import wer as jwer
from frankenstein_tpu.models.franky import Franky as JFranky
from frankenstein_tpu.models.import_reference import export_franky
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.data import datasets, native, text, tokenizers
from frankenstein_tpu_torch.eval import evaluate, submission, wer
from frankenstein_tpu_torch.models.franky import Franky
from frankenstein_tpu_torch.models.weights import load_strict

torch.set_num_threads(1)

SENTENCES = ["Hello, World!", "it's   a day... (really)", "", "ÀB-c d'e",
             "we need to talk now", "they can't hear; here!"]


@pytest.mark.parametrize("fn", ["process_string", "remove_punctuation"])
def test_text_normalization_matches(fn):
    for s in SENTENCES:
        assert getattr(text, fn)(s) == getattr(jtext, fn)(s)


def test_token_padding_matches():
    for toks in ([], [1, 2, 3], list(range(30))):
        padded = text.pad_token_list(toks, 25)
        assert padded == jtext.pad_token_list(toks, 25)
        assert text.remove_padding(padded) == jtext.remove_padding(padded)


def test_wer_matches():
    rng = np.random.default_rng(0)
    words = "a b c d e f".split()
    refs = [" ".join(rng.choice(words, rng.integers(0, 8)))
            for _ in range(40)]
    hyps = [" ".join(rng.choice(words, rng.integers(0, 8)))
            for _ in range(40)]
    assert wer.corpus_wer(refs, hyps) == jwer.corpus_wer(refs, hyps)
    for r, h in zip(refs, hyps):
        assert wer.sentence_wer(r, h) == jwer.sentence_wer(r, h)


def test_submission_writer_matches(tmp_path):
    got = submission.create_string_file(tmp_path / "port.txt", SENTENCES)
    want = jsubmission.create_string_file(tmp_path / "jax.txt", SENTENCES)
    assert got.read_bytes() == want.read_bytes()
    assert len(got.read_text().splitlines()) == len(SENTENCES)
    ds = datasets.BrainDataset.synthetic(5, seed=1, n_electrodes=8,
                                         max_input_len=16)
    fake = lambda xs: [f"{x.sum():.3f}" for x in xs]
    assert (submission.make_predictions(ds, fake, batch_size=2)
            == jsubmission.make_predictions(ds, fake, batch_size=2))


def test_synthetic_dataset_and_batches_match():
    kw = dict(n_electrodes=8, max_input_len=64)
    ds = datasets.BrainDataset.synthetic(7, seed=2, **kw)
    jds = jdatasets.BrainDataset.synthetic(7, seed=2, **kw)
    assert ds.targets == jds.targets and len(ds) == len(jds) == 7
    for i in range(len(ds)):
        x, y, d = ds[i]
        jx, jy, jd = jds[i]
        np.testing.assert_array_equal(x, jx)
        assert y == jy and d == jd
    tokenized = datasets.BrainDataset.synthetic(
        4, seed=3, tokenize_function=tokenizers.get_tokenizer(
            tokenizers.ByteTokenizer()), **kw)
    jtokenized = jdatasets.BrainDataset.synthetic(
        4, seed=3, tokenize_function=jtokenizers.get_tokenizer(
            jtokenizers.ByteTokenizer()), **kw)
    for a, b in zip(tokenized.as_arrays(), jtokenized.as_arrays()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(datasets.batch_iterator(tokenized, 3, shuffle=True,
                                            seed=4, epochs=2),
                    jdatasets.batch_iterator(jtokenized, 3, shuffle=True,
                                             seed=4, epochs=2)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_block_scaling_matches():
    rng = np.random.default_rng(5)
    brains = [rng.standard_normal((int(rng.integers(5, 9)), 4)).astype(
        np.float32) for _ in range(6)]
    blocks = [0, 1, 0, 2, 1, 1]
    for fn in ("z_score_per_block_scaling", "min_max_per_block_scaling"):
        for a, b in zip(getattr(datasets, fn)(brains, blocks),
                        getattr(jdatasets, fn)(brains, blocks)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(datasets.pad_truncate_brain_list(brains, 7),
                    jdatasets.pad_truncate_brain_list(brains, 7)):
        np.testing.assert_array_equal(a, b)


def test_native_binding_matches():
    """The copied ctypes binding (or its numpy fallback where the host
    library is not built) gives the original's results."""
    rng = np.random.default_rng(8)
    brains = [rng.standard_normal((int(rng.integers(5, 9)), 4)).astype(
        np.float32) for _ in range(5)]
    blocks = [3, 1, 3, 1, 2]
    assert native.available() == jnative.available()
    for a, b in zip(native.z_score_per_block_scaling(brains, blocks),
                    jnative.z_score_per_block_scaling(brains, blocks)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(native.gaussian_smooth(brains[0], 1.0),
                                  jnative.gaussian_smooth(brains[0], 1.0))
    np.testing.assert_array_equal(native.pad_truncate(brains[1], 6),
                                  jnative.pad_truncate(brains[1], 6))


def _bpe_assets(tmp_path):
    """A tiny GPT-2-style vocabulary: the 256 byte symbols, four merges and
    <|endoftext|>."""
    symbols = list(jtokenizers._bytes_to_unicode().values())
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("Ġ", "w")]
    vocab = {s: i for i, s in enumerate(symbols)}
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


def test_gpt2_bpe_matches(tmp_path, monkeypatch):
    paths = _bpe_assets(tmp_path)
    tok, jtok = tokenizers.GPT2BPE(*paths), jtokenizers.GPT2BPE(*paths)
    sample = "hello world, hell<|endoftext|>héllo 42"
    ids = tok.encode(sample)
    assert ids == jtok.encode(sample) and tok.eot_id == jtok.eot_id
    assert tok.decode(ids) == jtok.decode(ids) == sample
    assert (tok.decode(ids, skip_special_tokens=True)
            == jtok.decode(ids, skip_special_tokens=True))
    assert (tokenizers.get_tokenizer(tok)("hello")
            == jtokenizers.get_tokenizer(jtok)("hello"))
    monkeypatch.setenv("GPT2_BPE_DIR", str(tmp_path))
    assert tokenizers.find_gpt2_assets() == paths
    assert isinstance(tokenizers.best_available_tokenizer(),
                      tokenizers.GPT2BPE)
    monkeypatch.setenv("GPT2_BPE_DIR", str(tmp_path / "missing"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    assert tokenizers.find_gpt2_assets() is None
    assert isinstance(tokenizers.best_available_tokenizer(),
                      tokenizers.ByteTokenizer)


def _tiny_cfg(mod):
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


def test_evaluate_franky_wer_matches_jax():
    """Beams of width 2 over a 6-trial synthetic set in batches of 4 (the
    last batch padded): the same predictions and WER as the JAX package."""
    rng = np.random.default_rng(6)
    jmodel = JFranky(_tiny_cfg(jconfig))
    params = jmodel.init(jax.random.key(1), jnp.zeros((1, 32, 8)),
                         jnp.zeros((1, 6), jnp.int32))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    model = load_strict(Franky(_tiny_cfg(tconfig)), export_franky(params))
    kw = dict(batch_size=4, max_new_tokens=6, beam_width=2, eot_id=299)
    ds_kw = dict(n_electrodes=8, max_input_len=32)
    want_wer, want = jevaluate.evaluate_franky_wer(
        jmodel, params, jdatasets.BrainDataset.synthetic(6, seed=7, **ds_kw),
        jtokenizers.ByteTokenizer(eot_id=299), **kw)
    got_wer, got = evaluate.evaluate_franky_wer(
        model, datasets.BrainDataset.synthetic(6, seed=7, **ds_kw),
        tokenizers.ByteTokenizer(eot_id=299), **kw)
    assert len(got) == 6 and got == want
    assert np.isfinite(got_wer) and got_wer == want_wer
