"""Weights for the port's Franky.

``load_franky`` takes the dict of numpy arrays that the JAX package's
``models/import_reference.py:export_franky`` writes (the reference's torch
state-dict names and layouts) and loads it with ``strict=True``, so the
exporter is the bridge from any JAX checkpoint. ``init_franky_`` draws
random weights from a seed at the JAX initialisers' scales (not the same
draws: the two frameworks' generators differ).
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from frankenstein_tpu_torch.models.franky import Franky
from frankenstein_tpu_torch.models.gpt2 import init_gpt_


def load_franky(model: Franky, state: Mapping[str, np.ndarray]) -> Franky:
    """Copy an ``export_franky`` dict into ``model`` (strict: every tensor
    must map, and every parameter must be given). ``lm_head.weight`` stays
    tied to ``transformer.wte.weight``."""
    ref = model.state_dict()
    tensors = {}
    for name, value in state.items():
        if name not in ref:
            raise KeyError(f"unexpected tensor {name!r}")
        tensors[name] = torch.tensor(np.asarray(value),
                                     dtype=ref[name].dtype,
                                     device=ref[name].device)
    model.load_state_dict(tensors, strict=True)
    return model


def init_franky_(model: Franky, seed: int) -> Franky:
    """Random weights from ``seed``: linear kernels at lecun-normal scale
    (std 1/sqrt(fan_in)), the space embedding at std 1, learnable queries at
    zero, unit norms, zero biases; GPT-2 at normal(0.02)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    brain = model.brain_model
    with torch.no_grad():
        for name, p in brain.named_parameters():
            if name.endswith("bias") or name == "learnable_queries":
                nn.init.zeros_(p)
            elif ".ln_" in name:
                nn.init.ones_(p)
            elif name == "encoder.space_embedding":
                p.normal_(0.0, 1.0, generator=gen)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
    init_gpt_(model.llm_model, gen)
    return model
