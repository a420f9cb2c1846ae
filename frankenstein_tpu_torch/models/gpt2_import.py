"""HF GPT-2 checkpoint import into the port's ``GPT``
(``frankenstein_tpu/models/gpt2_import.py``: ``config_for``,
``params_from_hf_state_dict``, ``params_from_hf_model``).

HF's GPT-2 stores its attention and MLP matrices as "Conv1D" weights,
[in, out]; the port's ``nn.Linear`` holds [out, in], so every Conv1D weight
is transposed, the square ``attn.c_proj`` included (a shape test cannot
tell its two layouts apart). LayerNorm and embedding tensors copy over as
they are; ``lm_head`` is tied to ``transformer.wte``, so HF's head is
dropped. Works offline: a mapping of HF names to arrays (a local
checkpoint's state dict) or an in-memory ``transformers.GPT2LMHeadModel``;
nothing is downloaded.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from frankenstein_tpu_torch.config import GPTConfig

# HF model-type geometry
HF_CONFIGS = {
    "gpt2": dict(n_layer=12, n_head=12, n_embd=768),
    "gpt2-medium": dict(n_layer=24, n_head=16, n_embd=1024),
    "gpt2-large": dict(n_layer=36, n_head=20, n_embd=1280),
    "gpt2-xl": dict(n_layer=48, n_head=25, n_embd=1600),
}


def config_for(model_type: str) -> GPTConfig:
    """The GPTConfig of a published GPT-2 size: HF's vocabulary of 50257
    (not the port's padded default) and 1024 positions."""
    return GPTConfig(vocab_size=50257, block_size=1024, bias=True,
                     **HF_CONFIGS[model_type])


def params_from_hf_state_dict(sd: Mapping, cfg: GPTConfig) -> dict:
    """HF GPT-2 state dict (names with or without ``transformer.``, values
    numpy arrays or tensors) -> the port's ``GPT`` state dict as float32
    numpy arrays, for ``models.weights.load_strict``. Shapes are checked
    against ``cfg``."""
    src = {}
    for name, value in sd.items():
        if name.startswith("transformer."):
            name = name[len("transformer."):]
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        src[name] = np.asarray(value, np.float32)
    e = cfg.n_embd
    # a block's HF Conv1D weights, [in, out], under ``h.{i}.``
    conv1d = {"attn.c_attn": (e, 3 * e), "attn.c_proj": (e, e),
              "mlp.c_fc": (e, 4 * e), "mlp.c_proj": (4 * e, e)}
    out = {}

    def copy(name, shape):
        if src[name].shape != shape:
            raise ValueError(f"{name}: shape {src[name].shape}, want {shape}")
        out[f"transformer.{name}"] = src[name]

    copy("wte.weight", (cfg.vocab_size, e))
    copy("wpe.weight", (cfg.block_size, e))
    norms = ["ln_f"]
    for i in range(cfg.n_layer):
        norms += [f"h.{i}.ln_1", f"h.{i}.ln_2"]
        for conv, shape in conv1d.items():
            name = f"h.{i}.{conv}"
            if src[f"{name}.weight"].shape != shape:
                raise ValueError(f"{name}.weight: shape "
                                 f"{src[name + '.weight'].shape}, Conv1D "
                                 f"[in, out] {shape}")
            out[f"transformer.{name}.weight"] = src[f"{name}.weight"].T
            if cfg.bias:
                copy(f"{name}.bias", (shape[1],))
    for name in norms:
        copy(f"{name}.weight", (e,))
        if cfg.bias:
            copy(f"{name}.bias", (e,))
    out["lm_head.weight"] = out["transformer.wte.weight"]      # tied
    return out


def params_from_hf_model(hf_model, cfg: Optional[GPTConfig] = None) -> tuple:
    """(state dict, GPTConfig) from an in-memory
    ``transformers.GPT2LMHeadModel``; the config is read from the model's
    own unless given."""
    if cfg is None:
        c = hf_model.config
        cfg = GPTConfig(vocab_size=c.vocab_size, block_size=c.n_positions,
                        n_layer=c.n_layer, n_head=c.n_head, n_embd=c.n_embd,
                        bias=True)
    return params_from_hf_state_dict(hf_model.state_dict(), cfg), cfg
