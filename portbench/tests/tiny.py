"""Tiny cells for the harness's CPU tests: the real cells' traffic at a
size the CPU holds, on configurations of the same models."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench import run as run_lib

ROOT = Path(__file__).resolve().parents[2]

FRANKY = {
    "name": "tiny-franky", "model": "franky",
    "model_config": {
        "brain": {"encoder": {"window_size": 64, "n_electrodes": 16,
                              "patch_size": 8, "dim": 32, "n_layers": 2,
                              "head_dim": 8, "hidden_dim": 64, "n_heads": 4,
                              "n_kv_heads": 4},
                  "n_output_tokens": 4, "output_dim": 256, "dim": 32,
                  "n_layers": 1, "head_dim": 8, "hidden_dim": 64,
                  "n_heads": 4, "n_kv_heads": 4},
        "gpt": {"block_size": 64, "vocab_size": 50304, "n_layer": 2,
                "n_head": 4, "n_embd": 256, "dropout": 0.0}},
    "train": {"batch_size": 8, "learning_rate": 1e-3, "weight_decay": 1e-5,
              "warmup_iters": 2000, "lr_decay_iters": 50000,
              "grad_clip": 1.0, "mixed_precision": True}}

MAE = {
    "name": "tiny-mae", "model": "mae",
    "model_config": {"window_size": 64, "n_electrodes": 16, "patch_size": 8,
                     "dim": 32, "n_layers": 2, "head_dim": 8,
                     "hidden_dim": 64, "n_heads": 4, "n_kv_heads": 4,
                     "n_dec_layers": 2, "decoder_dim": 32,
                     "masking_ratio": 0.75},
    "train": {"batch_size": 8, "learning_rate": 1e-3, "weight_decay": 1e-5,
              "warmup_iters": 2000, "lr_decay_iters": 50000,
              "mixed_precision": True, "remat": False}}

# each real cell's traffic, cut to the CPU: (configuration, overrides)
CELLS = {
    "franky.submit-beam5-b32": (FRANKY, {"batch": 4, "pool_batches": 2,
                                         "check_sentences": 8}),
    "franky.offline-topk-b128": (FRANKY, {"batch": 4, "pool_batches": 2,
                                          "check_sentences": 8}),
    "mae.pretrain-b256": (MAE, {"batch": 8, "grad_accum": 2,
                                "ref_rows": 2}),
    "franky.train-b256": (FRANKY, {"batch": 8, "grad_accum": 2,
                                   "ref_rows": 2, "max_tokens": 6,
                                   "min_words": 1}),
}


def spec(cell: str, root: Path = ROOT) -> run_lib.Spec:
    """The cell's spec from ``BENCHMARK.json`` with its configuration and
    traffic cut to the CPU."""
    real = run_lib.load_spec(root, cell)
    config, over = CELLS[cell]
    traffic = dict(copy.deepcopy(real.traffic), **over)
    return run_lib.Spec(real.root, cell, real.chips, copy.deepcopy(config),
                        traffic, real.end_to_end, real.per_layer)


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
