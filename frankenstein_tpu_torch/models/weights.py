"""Weights for the port's models.

``load_strict`` loads a dict of numpy arrays under the port's state-dict
names with ``strict=True``. For Franky that is the dict the JAX package's
``models/import_reference.py:export_franky`` writes (the reference's torch
names and layouts), so the exporter is the bridge from any JAX checkpoint;
for the MAE it is ``export_mae``'s; for SimpleMAE ``export_simple_mae``'s;
for BrainFormer ``export_brain_encoder(params["brain"], head="to_motion",
prefix="brain.")``; for FrankyLlama it is the brain's
``export_brain_encoder(..., prefix="brain_model.")`` merged with the
LLaMA's ``llama_state_from_flax(..., prefix="llm_model.")``. For a GPT,
dense or MoE, it is ``gpt_state_from_flax`` (the JAX ``export_gpt`` reads
``c_fc`` and so cannot export an MoE GPT); a Franky with an MoE GPT is the
brain's ``export_brain_encoder(..., prefix="brain_model.")`` merged with
``gpt_state_from_flax(params["llm_model"], prefix="llm_model.")``.

For SoundStream it is ``export_soundstream(variables)``: the flax
parameters and the ``"vq"`` collection under the reference's names, the
transposed convs' kernels flipped back to torch's layout and ``initted``
written as 1.

For BrainWhisper the bridge is ``whisper_state_from_flax``: the JAX
package has no exporter for it, and the port's names are HF's, so it is
the inverse of the JAX ``params_from_hf_whisper``'s mapping.

The session embedding (``MAEConfig.n_sessions`` > 0) is the port's and the
JAX package's own: the reference has no slot for it, so the exporters
drop it (``_export_encoder``). Its row comes across by name from the JAX
parameters, ``encoder.date_embedding`` [n_sessions, dim] to
``<prefix>encoder.date_embedding`` (``date_embedding_state``).

``init_franky_``, ``init_mae_``, ``init_simple_mae_``, ``init_brainformer_``,
``init_franky_llama_``, ``init_whisper_`` and ``init_soundstream_`` draw
random weights from a
seed at the JAX initialisers' scales (not the same draws: the two
frameworks' generators differ); ``init_franky_`` covers an MoE GPT (router
and experts at normal(0.02)), ``init_franky_llama_`` an MoE LLaMA.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from frankenstein_tpu_torch.models.brainformer import MAE, BrainFormer
from frankenstein_tpu_torch.models.franky import Franky, FrankyLlama
from frankenstein_tpu_torch.models.gpt2 import init_gpt_
from frankenstein_tpu_torch.models.simple_mae import SimpleMAE
from frankenstein_tpu_torch.models.vq_brain import SoundStream
from frankenstein_tpu_torch.models.whisper import BrainWhisper


def load_strict(model: nn.Module, state: Mapping[str, np.ndarray]):
    """Copy ``state`` (numpy arrays or tensors) into ``model`` (strict:
    every tensor must map, and every parameter must be given), each in its
    parameter's dtype. A tied
    head (GPT-2's ``lm_head.weight``) stays tied to its embedding."""
    ref = model.state_dict()
    tensors = {}
    for name, value in state.items():
        if name not in ref:
            raise KeyError(f"unexpected tensor {name!r}")
        tensors[name] = torch.as_tensor(value, dtype=ref[name].dtype,
                                        device=ref[name].device)
    model.load_state_dict(tensors, strict=True)
    return model


def llama_state_from_flax(tree: Mapping, prefix: str = "") -> dict:
    """The JAX package's flax ``Llama`` params as the port's state dict.

    ``tree``: ``embed`` [V, E], ``layers`` (``input_norm``, ``q_proj``, ...,
    ``post_attn_norm``, ..., ``down_proj`` or an MoE's ``moe``, each
    stacked [L, ...]),
    ``norm_f`` and, untied, ``lm_head`` [V, E], as numpy arrays. Dense
    kernels [in, out] become ``weight`` [out, in]; no RoPE permutation (the
    port rotates adjacent pairs, as the JAX package does). A tied head is
    given as ``lm_head.weight`` = the embedding."""
    layers = tree["layers"]
    n_layers = int(np.asarray(layers["input_norm"]["weight"]).shape[0])
    out = {f"{prefix}model.embed_tokens.weight": np.asarray(tree["embed"])}
    dense = {"self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
             "self_attn.v_proj": "v_proj", "self_attn.o_proj": "o_proj",
             "mlp.gate_proj": "gate_proj", "mlp.up_proj": "up_proj",
             "mlp.down_proj": "down_proj"}
    norms = {"input_layernorm": "input_norm",
             "post_attention_layernorm": "post_attn_norm"}
    for i in range(n_layers):
        bp = f"{prefix}model.layers.{i}."
        for name, flax in dense.items():
            if flax not in layers and "moe" in layers:
                continue
            out[f"{bp}{name}.weight"] = np.asarray(
                layers[flax]["kernel"])[i].T
        if "moe" in layers:
            _moe_state(out, bp, layers["moe"], i)
        for name, flax in norms.items():
            out[f"{bp}{name}.weight"] = np.asarray(layers[flax]["weight"])[i]
    out[f"{prefix}model.norm.weight"] = np.asarray(tree["norm_f"]["weight"])
    out[f"{prefix}lm_head.weight"] = np.asarray(tree.get("lm_head",
                                                         tree["embed"]))
    return out


def _moe_state(out: dict, bp: str, moe: Mapping, i: int) -> None:
    """A scanned MoESwiGLU's layer ``i`` (``wg`` [L, d, E], ``w1`` / ``w3``
    [L, E, d, f], ``w2`` [L, E, f, d]) as ``<bp>moe.*``, no transpose."""
    for name in ("wg", "w1", "w2", "w3"):
        out[f"{bp}moe.{name}"] = np.asarray(moe[name])[i]


def gpt_state_from_flax(tree: Mapping, prefix: str = "") -> dict:
    """The JAX package's flax ``GPT`` params (``{"params": ...}`` or the
    inner tree, as numpy) as the port's state dict, dense or MoE: the
    scanned [L, ...] blocks unstacked into ``transformer.h.{i}``, dense
    kernels [in, out] as ``weight`` [out, in], the MoE's router and
    expert stacks as they are, ``lm_head.weight`` the tied ``wte``."""
    p = tree.get("params", tree)
    h = p["h"]
    n_layer = int(np.asarray(h["ln_1"]["weight"]).shape[0])
    out = {f"{prefix}transformer.wte.weight": np.asarray(p["wte"]),
           f"{prefix}transformer.wpe.weight": np.asarray(p["wpe"])}

    def put(name, src, i):
        for key, value in src.items():
            arr = np.asarray(value)[i]
            tgt = "weight" if key == "kernel" else key
            out[f"{name}.{tgt}"] = arr.T if key == "kernel" else arr

    for i in range(n_layer):
        bp = f"{prefix}transformer.h.{i}."
        put(bp + "ln_1", h["ln_1"], i)
        put(bp + "attn.c_attn", h["c_attn"], i)
        put(bp + "attn.c_proj", h["c_proj"], i)
        put(bp + "ln_2", h["ln_2"], i)
        if "moe" in h:
            _moe_state(out, bp, h["moe"], i)
        else:
            put(bp + "mlp.c_fc", h["c_fc"], i)
            put(bp + "mlp.c_proj", h["mlp_c_proj"], i)
    for key, value in p["ln_f"].items():
        out[f"{prefix}transformer.ln_f.{key}"] = np.asarray(value)
    out[f"{prefix}lm_head.weight"] = np.asarray(p["wte"])
    return out


def date_embedding_state(tree: Mapping, prefix: str = "") -> dict:
    """The session embedding of a JAX encoder's params ``tree`` (the
    ``encoder`` subtree of an MAE, a BrainEncoder or a composite's brain),
    under the port's name; empty when the encoder has none."""
    if "date_embedding" not in tree:
        return {}
    return {f"{prefix}date_embedding": np.asarray(tree["date_embedding"],
                                                  np.float32)}


def _init_brain_(brain: nn.Module, gen: torch.Generator) -> None:
    """Linear kernels at lecun-normal scale (std 1/sqrt(fan_in)), the space
    embedding (and an MAE's mask token) at std 1, the session embedding at
    std 0.02, learnable queries at zero, unit norms, zero biases. An MAE's
    ``decoder_pos_emb`` [N, F] gets flax ``nn.Embed``'s default, std
    1/sqrt(F), the kernels' rule."""
    with torch.no_grad():
        for name, p in brain.named_parameters():
            if name.endswith("bias") or name == "learnable_queries":
                nn.init.zeros_(p)
            elif ".ln_" in name:
                nn.init.ones_(p)
            elif name in ("encoder.space_embedding", "mask_token"):
                p.normal_(0.0, 1.0, generator=gen)
            elif name == "encoder.date_embedding":
                p.normal_(0.0, 0.02, generator=gen)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)


def init_franky_(model: Franky, seed: int) -> Franky:
    """Random weights from ``seed``: the brain as ``_init_brain_``, GPT-2
    at normal(0.02) (an MoE GPT's router and experts too)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    _init_brain_(model.brain_model, gen)
    init_gpt_(model.llm_model, gen)
    return model


def init_mae_(model: MAE, seed: int) -> MAE:
    """Random weights from ``seed``, each at its JAX initialiser's scale
    (``_init_brain_``)."""
    gen = torch.Generator(device=model.mask_token.device).manual_seed(seed)
    _init_brain_(model, gen)
    return model


def init_simple_mae_(model: SimpleMAE, seed: int) -> SimpleMAE:
    """Random weights from ``seed`` at the JAX initialisers' scales
    (``_init_brain_``: the mask token at std 1, RMSNorm and LayerNorm
    weights at one)."""
    gen = torch.Generator(device=model.mask_token.device).manual_seed(seed)
    _init_brain_(model, gen)
    return model


def init_brainformer_(model: BrainFormer, seed: int) -> BrainFormer:
    """Random weights from ``seed``: the BrainEncoder as ``_init_brain_``."""
    gen = torch.Generator(
        device=model.brain.learnable_queries.device).manual_seed(seed)
    _init_brain_(model.brain, gen)
    return model


def init_franky_llama_(model: FrankyLlama, seed: int) -> FrankyLlama:
    """Random weights from ``seed``: the brain as ``_init_brain_``; the
    LLaMA's embedding, projections and head (and an MoE's router and
    experts) at normal(0.02), unit norms."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    _init_brain_(model.brain_model, gen)
    with torch.no_grad():
        for name, p in model.llm_model.named_parameters():
            if name.endswith("norm.weight"):        # the RMSNorm weights
                nn.init.ones_(p)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model


def whisper_state_from_flax(tree: Mapping) -> dict:
    """The JAX package's flax ``BrainWhisper`` params (``{"params": ...}``
    or the inner tree, as numpy) as the port's HF-named state dict: conv
    kernels [k, in, out] become [out, in, k], dense kernels [in, out]
    become [out, in], and ``proj_out.weight`` is the token embedding."""
    p = tree.get("params", tree)
    arr = lambda x: np.asarray(x, np.float32)
    out = {}

    def conv(name, src):
        out[f"{name}.weight"] = arr(src["kernel"]).transpose(2, 1, 0)
        out[f"{name}.bias"] = arr(src["bias"])

    def dense(name, src):
        out[f"{name}.weight"] = arr(src["kernel"]).T
        if "bias" in src:
            out[f"{name}.bias"] = arr(src["bias"])

    def norm(name, src):
        out[f"{name}.weight"] = arr(src["weight"])
        out[f"{name}.bias"] = arr(src["bias"])

    def layer(name, src, attns):
        for attn in attns:
            norm(f"{name}.{attn}_layer_norm", src[f"{attn}_layer_norm"])
            for proj in ("q", "k", "v", "out"):
                dense(f"{name}.{attn}.{proj}_proj",
                      src[attn][f"{proj}_proj"])
        norm(f"{name}.final_layer_norm", src["final_layer_norm"])
        dense(f"{name}.fc1", src["mlp"]["fc1"])
        dense(f"{name}.fc2", src["mlp"]["fc2"])

    conv("model.encoder.conv1", p["conv1"])
    conv("model.encoder.conv2", p["conv2"])
    i = 0
    while f"enc_{i}" in p:
        layer(f"model.encoder.layers.{i}", p[f"enc_{i}"], ["self_attn"])
        i += 1
    norm("model.encoder.layer_norm", p["enc_ln"])
    out["model.decoder.embed_tokens.weight"] = arr(p["embed_tokens"])
    out["model.decoder.embed_positions.weight"] = arr(p["embed_positions"])
    i = 0
    while f"dec_{i}" in p:
        layer(f"model.decoder.layers.{i}", p[f"dec_{i}"],
              ["self_attn", "encoder_attn"])
        i += 1
    norm("model.decoder.layer_norm", p["dec_ln"])
    out["proj_out.weight"] = out["model.decoder.embed_tokens.weight"]
    return out


def init_whisper_(model: BrainWhisper, seed: int) -> BrainWhisper:
    """Random weights from ``seed`` at the flax initialisers' scales:
    linear and conv kernels lecun normal (std 1/sqrt(fan_in), fan_in = in
    x kernel width for a conv), zero biases, unit LayerNorm weights, and
    N(0, 0.02) for the token and position embeddings."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("embed_tokens.weight",
                              "embed_positions.weight")):
                p.normal_(0.0, 0.02, generator=gen)
            elif name.endswith("bias"):
                nn.init.zeros_(p)
            elif "layer_norm" in name:
                nn.init.ones_(p)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=gen)
    return model


def init_soundstream_(model: SoundStream, seed: int) -> SoundStream:
    """Random weights from ``seed`` at the flax initialisers' scales: conv
    kernels lecun normal (std 1/sqrt(in x width), for the transposed convs'
    [in, out, k] too), zero biases; the codebook at N(0, 0.02), as the JAX
    quantizer's, with unit cluster sizes, ``embed_avg`` equal to it, and
    ``initted`` 0 under ``kmeans_init`` (the first train batch sets it)."""
    book = model.quantizer._codebook
    gen = torch.Generator(device=book.embed.device).manual_seed(seed)
    with torch.no_grad():
        for conv in model.modules():
            if isinstance(conv, nn.ConvTranspose1d):     # [in, out, k]
                fan_in = conv.weight.shape[0] * conv.weight.shape[2]
            elif isinstance(conv, nn.Conv1d):            # [out, in, k]
                fan_in = conv.weight[0].numel()
            else:
                continue
            conv.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
            nn.init.zeros_(conv.bias)
        book.embed.normal_(0.0, 0.02, generator=gen)
        book.cluster_size.fill_(1.0)
        book.embed_avg.copy_(book.embed)
        book.initted.fill_(0.0 if model.cfg.kmeans_init else 1.0)
    return model
