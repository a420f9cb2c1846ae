"""The program's Franky as the benchmark drives it: the served model and
its predictor, the trained model, and the inputs of both, drawn from the
seed. Its plain twin is ``reference/franky.py``."""

from __future__ import annotations

import numpy as np

from portbench import weights
from portbench.reference import franky as ref

IGNORE = -100


def build_training(model_config: dict, dev, dtype):
    from frankenstein_tpu_torch.config import FrankyConfig
    from frankenstein_tpu_torch.models.franky import Franky
    return Franky(FrankyConfig.from_dict(model_config), device=dev,
                  dtype=dtype)


def build_serving(spec, seed: int, device: str):
    """(model, predictor, the model's parameter names and shapes) for the
    cell, the weights the benchmark's own, in the served dtype."""
    import torch
    from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
    from frankenstein_tpu_torch.decode import pipeline
    mc, tr = spec.config["model_config"], spec.traffic
    model = build_training(mc, torch.device(device), None)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    model = pipeline.cast_params_for_inference(model)
    weights.load(model, weights.make(shapes, ref.init_rule, seed, device,
                                     torch.bfloat16, ref.n_layer(mc)))
    predict = pipeline.make_franky_predictor(
        model, ByteTokenizer(), max_new_tokens=tr["max_new_tokens"],
        top_k=tr.get("top_k"), beam_width=tr.get("beam_width", 0),
        int8_weights=tr.get("int8_weights", False),
        int8_kv=tr.get("int8_kv", False), seed=seed)
    return model, predict, shapes


def windows(spec, seed: int, device: str):
    """``pool_batches`` x ``batch`` windows [T, C] f32 drawn from the seed
    on the device, as one tensor."""
    import torch
    enc = spec.config["model_config"]["brain"]["encoder"]
    tr = spec.traffic
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(tr["pool_batches"], tr["batch"], enc["window_size"],
                       enc["n_electrodes"], generator=gen, device=device)


def serving_pool(spec, seed: int, device: str) -> list:
    """The requests' windows: ``pool_batches`` host tensors [B, T, C]."""
    return list(windows(spec, seed, device).cpu().unbind(0))


def training_pool(spec, seed: int, device: str) -> list:
    """``pool_batches`` host batches (windows, targets), every row its own:
    targets [B, max_tokens] of random GPT-2 ids framed by <|endoftext|>,
    with -100 padding."""
    tr = spec.traffic
    x = windows(spec, seed, device).cpu().numpy()
    rng = np.random.default_rng(seed)
    n_tok = tr["max_tokens"]
    y = np.full((len(x), tr["batch"], n_tok), IGNORE, np.int64)
    lengths = rng.integers(tr["min_words"], n_tok - 1, size=y.shape[:2])
    for i in range(len(x)):
        for r in range(tr["batch"]):
            n = int(lengths[i, r])
            y[i, r, 0] = ref.EOT
            y[i, r, 1:n + 1] = rng.integers(0, ref.EOT, size=n)
            y[i, r, n + 1] = ref.EOT
    return [(x[i], y[i]) for i in range(len(x))]
