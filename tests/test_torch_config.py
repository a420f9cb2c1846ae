"""The port's config dataclasses are copies of the JAX package's (the port
cannot import those without jax): same fields, defaults, derived
properties and JSON round trip."""

import dataclasses

import pytest

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.models import franky as jfranky
from frankenstein_tpu.models import llama as jllama
from frankenstein_tpu_torch import config as tconfig

NAMES = ["MAEConfig", "PerceiverConfig", "GPTConfig", "FrankyConfig",
         "TrainConfig", "LlamaConfig", "FrankyLlamaConfig",
         "SimpleEncoderConfig", "SimpleMAEConfig", "VQVAEConfig"]
# where the JAX package keeps each class
JAX_HOME = {"LlamaConfig": jllama, "FrankyLlamaConfig": jfranky}


def _classes(name):
    return getattr(JAX_HOME.get(name, jconfig), name), getattr(tconfig, name)


@pytest.mark.parametrize("name", NAMES)
def test_fields_and_defaults(name):
    jcls, tcls = _classes(name)
    jf = [(f.name, str(f.type)) for f in dataclasses.fields(jcls)]
    tf = [(f.name, str(f.type)) for f in dataclasses.fields(tcls)]
    assert tf == jf
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


@pytest.mark.parametrize("const", ["GPT2_EOT", "IGNORE_INDEX", "MAX_TOKENS",
                                   "MAX_INPUT_LEN", "N_ELECTRODES"])
def test_constants(const):
    assert getattr(tconfig, const) == getattr(jconfig, const)


def test_derived_properties():
    for enc in ({}, {"window_size": 768, "patch_size": 32},
                {"window_size": 32, "n_electrodes": 8, "patch_size": 8}):
        j, t = jconfig.MAEConfig(**enc), tconfig.MAEConfig(**enc)
        assert t.n_patches_per_channel == j.n_patches_per_channel
        assert t.block_size == j.block_size
    for gpt in ({}, {"n_embd": 128, "n_head": 4}):
        assert (tconfig.GPTConfig(**gpt).head_dim
                == jconfig.GPTConfig(**gpt).head_dim)
    for lm in ({}, {"dim": 1024, "n_heads": 16}):
        assert (tconfig.LlamaConfig(**lm).head_dim
                == jllama.LlamaConfig(**lm).head_dim)


@pytest.mark.parametrize("kw", [{}, {"vocab_size": 300, "n_kv_heads": 4}])
def test_tiny_llama_config(kw):
    assert (dataclasses.asdict(tconfig.tiny_llama_config(**kw))
            == dataclasses.asdict(jllama.tiny_llama_config(**kw)))



@pytest.mark.parametrize("name", NAMES)
def test_json_round_trip_matches_jax(name):
    """Each side reads the other's JSON (nested configs rebuild as
    dataclasses, lists as tuples) and writes the same dict."""
    jcls, tcls = _classes(name)
    changed = {"TrainConfig": {"mesh_shape": (1, 1), "batch_size": 32},
               "FrankyConfig": {"max_tokens": 9},
               "GPTConfig": {"n_layer": 2}, "LlamaConfig": {"n_layers": 3},
               "FrankyLlamaConfig": {"pad_token_id": 7},
               "SimpleEncoderConfig": {"block_size": 768, "patch_size": 256},
               "SimpleMAEConfig": {"masking_ratio": 0.5},
               "VQVAEConfig": {"strides": (2, 3), "C": 64}}.get(name, {})
    j, t = jcls(**changed), tcls(**changed)
    assert tcls.from_json(j.to_json()) == t
    assert jcls.from_json(t.to_json()) == j
    assert t.to_dict() == j.to_dict()
    assert t.replace(**changed) == t
