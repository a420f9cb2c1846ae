"""The port's HF GPT-2 importer against HF and the JAX package's importer,
offline: a randomly initialised ``transformers.GPT2LMHeadModel`` built from
a ``GPT2Config`` (no download), imported into the port's ``GPT``, gives
HF's logits within 2e-4 and the JAX package's imported weights (through
``export_gpt``) exactly; every Conv1D weight is transposed, the square
``attn.c_proj`` included; ``config_for`` gives the published geometry with
HF's vocabulary."""

import jax
import numpy as np
import pytest
import torch

from frankenstein_tpu.models import gpt2_import as jimport
from frankenstein_tpu.models.import_reference import export_gpt
from frankenstein_tpu_torch.config import GPTConfig
from frankenstein_tpu_torch.models import gpt2_import
from frankenstein_tpu_torch.models.gpt2 import GPT
from frankenstein_tpu_torch.models.weights import load_strict

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

LOGIT_TOL = 2e-4     # f32 logits against HF's (docs/migrating.md)


def _hf(n_embd=32, n_layer=2, n_head=2, vocab=96, positions=64, seed=0):
    cfg = transformers.GPT2Config(
        vocab_size=vocab, n_positions=positions, n_embd=n_embd,
        n_layer=n_layer, n_head=n_head, resid_pdrop=0.0, embd_pdrop=0.0,
        attn_pdrop=0.0)
    torch.manual_seed(seed)
    return transformers.GPT2LMHeadModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_pair():
    hf = _hf()
    state, cfg = gpt2_import.params_from_hf_model(hf)
    return hf, load_strict(GPT(cfg), state), state, cfg


@pytest.mark.parametrize("t", [1, 10, 64])
def test_logits_match_hf(hf_pair, t):
    hf, model, _, cfg = hf_pair
    idx = torch.from_numpy(np.random.default_rng(t).integers(
        0, cfg.vocab_size, size=(2, t)))
    with torch.no_grad():
        want = hf(idx).logits
        got = model(idx, targets=idx)[1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_TOL)


def test_state_equals_the_jax_import_exported(hf_pair):
    """``export_gpt`` of the JAX package's import (flax kernels [in, out])
    is the port's state ([out, in]) exactly."""
    hf, _, state, _ = hf_pair
    params, _ = jimport.params_from_hf_model(hf)
    want = export_gpt(jax.tree_util.tree_map(np.asarray, params))
    assert set(state) == set(want)
    for name in want:
        np.testing.assert_array_equal(state[name], want[name], err_msg=name)


def test_every_conv1d_weight_is_transposed(hf_pair):
    """The square c_proj [E, E] is transposed like the others: the port's
    projection of x is x @ W_hf, HF's Conv1D product."""
    hf, model, state, cfg = hf_pair
    sd = hf.state_dict()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, cfg.n_embd)).astype(np.float32))
    for i in range(cfg.n_layer):
        block = model.transformer["h"][i]
        for conv, layer in (("attn.c_attn", block.attn.c_attn),
                            ("attn.c_proj", block.attn.c_proj),
                            ("mlp.c_fc", block.mlp.c_fc)):
            w = sd[f"transformer.h.{i}.{conv}.weight"]
            b = sd[f"transformer.h.{i}.{conv}.bias"]
            torch.testing.assert_close(layer(x).detach(), x @ w + b)
            np.testing.assert_array_equal(
                state[f"transformer.h.{i}.{conv}.weight"], w.numpy().T)
        h = torch.randn(3, 4 * cfg.n_embd, generator=torch.Generator(
            ).manual_seed(i))
        torch.testing.assert_close(
            block.mlp.c_proj(h).detach(),
            h @ sd[f"transformer.h.{i}.mlp.c_proj.weight"]
            + sd[f"transformer.h.{i}.mlp.c_proj.bias"])


def test_head_is_tied_and_names_take_either_prefix(hf_pair):
    hf, model, state, cfg = hf_pair
    assert model.lm_head.weight is model.transformer["wte"].weight
    np.testing.assert_array_equal(state["lm_head.weight"],
                                  state["transformer.wte.weight"])
    bare = {k[len("transformer."):] if k.startswith("transformer.") else k:
            v.numpy() for k, v in hf.state_dict().items()}
    again = gpt2_import.params_from_hf_state_dict(bare, cfg)
    for name in state:
        np.testing.assert_array_equal(again[name], state[name])


@pytest.mark.parametrize("kind", ["gpt2", "gpt2-medium", "gpt2-large",
                                  "gpt2-xl"])
def test_config_for_matches_jax(kind):
    got, want = gpt2_import.config_for(kind), jimport.config_for(kind)
    assert got.to_dict() == want.to_dict()
    assert got.vocab_size == 50257 and got.block_size == 1024


def test_wrong_geometry_raises(hf_pair):
    hf, _, _, cfg = hf_pair
    with pytest.raises(ValueError, match="wte.weight"):
        gpt2_import.params_from_hf_state_dict(
            hf.state_dict(), GPTConfig(**{**cfg.to_dict(), "n_embd": 48}))
    bad = dict(hf.state_dict())
    bad["transformer.h.0.mlp.c_fc.weight"] = bad[
        "transformer.h.0.mlp.c_fc.weight"].t()
    with pytest.raises(ValueError, match=r"mlp.c_fc.weight.*Conv1D"):
        gpt2_import.params_from_hf_state_dict(bad, cfg)
