"""The port's config dataclasses are copies of the JAX package's (the port
cannot import those without jax): same fields, defaults and derived
properties."""

import dataclasses

import pytest

from frankenstein_tpu import config as jconfig
from frankenstein_tpu_torch import config as tconfig

NAMES = ["MAEConfig", "PerceiverConfig", "GPTConfig", "FrankyConfig"]


@pytest.mark.parametrize("name", NAMES)
def test_fields_and_defaults(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
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

