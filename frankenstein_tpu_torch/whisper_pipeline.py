"""Fine-tune the whisper path on brain data (the port of
``examples/whisper_pipeline.py``).

  python -m frankenstein_tpu_torch.whisper_pipeline --data synthetic \\
      --steps 5000 --batch-size 16

The prep fits a PCA on the train trials' 256 voltage channels, keeps 80
components, resamples 50 -> 100 Hz and zero-pads to 3000 frames
(``data/whisper_prep.py``); labels are the tokenizer's ids cut to 30 and
padded with -100 to 32. The model (whisper-tiny geometry, seeded random
weights, or a local HF checkpoint with ``--hf-whisper DIR`` when
``transformers`` is installed) trains with f32 parameters and bf16 compute
through ``train/trainer.py:run_train_model``, and each eval round scores the
WER of 64 validation inputs (``evaluate_seq2seq_wer``), by which the best
checkpoint is kept. The run directory (``<save-folder>/whisper_brain``)
gets ``train_config.json``, ``metrics.jsonl`` and the checkpoints.
``--data`` is ``synthetic`` (128 train and 32 validation trials) or a
competitionData root with ``train/`` and ``test/``. The pipeline runs on the
GPU (``--device cuda``, the default; without a usable GPU it exits) or, when
asked, on the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np

from frankenstein_tpu_torch.config import (IGNORE_INDEX, TrainConfig,
                                           WhisperConfig)

LABEL_TOKENS = 30      # tokens a label keeps
LABEL_LEN = 32         # label length after -100 padding
N_EVAL = 64            # validation inputs an eval round decodes
EVAL_INTERVAL = 500


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data", default="synthetic")
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=2.5e-5)
    p.add_argument("--hf-whisper", default=None,
                   help="a local HF whisper checkpoint directory (offline)")
    p.add_argument("--save-folder", default="logs")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; exits without a usable GPU) or cpu")
    return p.parse_args(argv)


class ArrayDataset:
    """(mel, labels, 0) items for the trainer's batcher. The session index
    is 0 for every input, as in the JAX pipeline; BrainWhisper ignores
    it."""

    def __init__(self, mels: np.ndarray, labels: np.ndarray):
        self.mels, self.labels = mels.astype(np.float32), labels

    def __len__(self):
        return len(self.mels)

    def __getitem__(self, i):
        return self.mels[i], self.labels[i], 0


class Pipeline(NamedTuple):
    model: object
    datasets: tuple                  # (train, val) ArrayDatasets
    config: TrainConfig
    eval_metric: Callable


def tokenize_labels(tokenizer, sentences) -> np.ndarray:
    """[N, LABEL_LEN] int64: each sentence's ids cut to LABEL_TOKENS, then
    -100. No end token is appended, as in the JAX pipeline."""
    def one(s):
        ids = tokenizer.encode(s)[:LABEL_TOKENS]
        return ids + [IGNORE_INDEX] * (LABEL_LEN - len(ids))
    return np.asarray([one(s) for s in sentences], np.int64)


def load_trials(data: str, n_train: int = 128, n_val: int = 32):
    """(train brains, train sentences, val brains, val sentences): seeded
    synthetic trials z-scored per block, or competitionData's train / test
    files."""
    from frankenstein_tpu_torch.data import datasets
    if data == "synthetic":
        brains, sentences, blocks = datasets.synthetic_trials(n_train, 0)
        brains = datasets.z_score_per_block_scaling(brains, blocks)
        val_brains, val_sentences, vb = datasets.synthetic_trials(n_val, 1)
        val_brains = datasets.z_score_per_block_scaling(val_brains, vb)
        return brains, sentences, val_brains, val_sentences
    root = Path(data)
    tr = datasets.process_all_files(root / "train")
    va = datasets.process_all_files(root / "test")
    return (tr["brain_list"], tr["sentence_list"], va["brain_list"],
            va["sentence_list"])


def _hf_model(path: str):
    try:
        from transformers import WhisperForConditionalGeneration
    except ImportError as e:
        raise SystemExit(f"--hf-whisper needs the transformers package, "
                         f"which is not installed ({e})")
    return WhisperForConditionalGeneration.from_pretrained(
        path, local_files_only=True)


def build(data: str = "synthetic", *, device, batch_size: int = 16,
          lr: float = 2.5e-5, steps: int = 5000,
          hf_whisper: Optional[str] = None,
          cfg: Optional[WhisperConfig] = None,
          eval_interval: int = EVAL_INTERVAL) -> Pipeline:
    """The model, data, TrainConfig and WER metric of a run on ``device``.
    ``cfg`` (whisper-tiny by default; an HF checkpoint brings its own) sets
    the prep's geometry: ``n_mels`` components, ``2 * n_audio_ctx``
    frames."""
    import torch

    from frankenstein_tpu_torch.data import tokenizers, whisper_prep
    from frankenstein_tpu_torch.eval.evaluate import evaluate_seq2seq_wer
    from frankenstein_tpu_torch.models import weights, whisper

    tok = tokenizers.best_available_tokenizer()
    state = None
    if hf_whisper:
        state, cfg = whisper.params_from_hf_whisper(_hf_model(hf_whisper))
    cfg = cfg or WhisperConfig()
    geometry = dict(n_components=cfg.n_mels, pad_length=2 * cfg.n_audio_ctx,
                    device=device)
    brains, sentences, val_brains, val_sentences = load_trials(data)
    mean, comps = whisper_prep.fit_pca(brains, device=device)
    mels = whisper_prep.prepare_brain_data_for_whisper(brains, mean, comps,
                                                       **geometry)
    val_mels = whisper_prep.prepare_brain_data_for_whisper(
        val_brains, mean, comps, **geometry)
    labels = tokenize_labels(tok, sentences)
    val_labels = tokenize_labels(tok, val_sentences)

    tcfg = TrainConfig(exp_name="whisper_brain", batch_size=batch_size,
                       learning_rate=lr, max_steps=steps,
                       eval_interval=eval_interval,
                       warmup_iters=len(mels) // batch_size)
    model = whisper.BrainWhisper(cfg, device=torch.device(device),
                                 dtype=torch.bfloat16)
    if state is None:
        weights.init_whisper_(model, seed=tcfg.seed)
    else:
        weights.load_strict(model, state)

    def wer_metric(train_state, step):
        # no start_id: the model's own prompt (an HF checkpoint's real ids)
        wer, _ = evaluate_seq2seq_wer(
            train_state.model, val_mels[:N_EVAL], val_sentences[:N_EVAL],
            tok, batch_size=batch_size)
        print(f"step {step}: WER {wer:.4f}")
        return wer

    return Pipeline(model, (ArrayDataset(mels, labels),
                            ArrayDataset(val_mels, val_labels)),
                    tcfg, wer_metric)


def main(argv=None):
    """Run the CLI; returns the final ``trainer.TrainState``."""
    from frankenstein_tpu_torch.train.trainer import run_train_model
    from frankenstein_tpu_torch.utils.device import cli_device

    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    device = cli_device(args.device)
    pipe = build(args.data, device=device, batch_size=args.batch_size,
                 lr=args.lr, steps=args.steps, hf_whisper=args.hf_whisper)
    state = run_train_model(pipe.model, pipe.datasets, pipe.config,
                            save_folder=Path(args.save_folder),
                            eval_metric=pipe.eval_metric)
    print(f"done at step {state.step}; logs in "
          f"{Path(args.save_folder) / pipe.config.exp_name}")
    return state


if __name__ == "__main__":
    main()
