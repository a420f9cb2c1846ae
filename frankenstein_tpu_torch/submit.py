"""eval.ai submission (the port of ``examples/submit_data.py``): decode every
held-out trial with a trained Franky (dense or MoE GPT) or FrankyLlama and
write one normalized line per trial to sub.txt.

  python -m frankenstein_tpu_torch.submit --run-dir logs/<exp> \\
      --data /data/competitionData

Two ways to point at a model:
  --run-dir logs/<exp>   the run's model_config.json (written by
                         ``python -m frankenstein_tpu_torch.train``) and its
                         best-by-val-loss checkpoint
  --checkpoint <dir>     an explicit step_*_loss_* directory (the flagship
                         geometry unless --run-dir gives the config)

``--data synthetic`` decodes ``--synthetic-trials`` synthetic windows
instead of a competitionData split. The model serves in bf16 through
``decode/pipeline.py:make_franky_predictor`` (beams of ``--beam-width``) on
the GPU (``--device cuda``, the default; without a usable GPU the CLI
exits) or, when asked, on the CPU (``--device cpu``). Under torchrun the
ranks split each batch (data-parallel serving,
``eval/submission.make_predictions``) and rank 0 writes the file.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def build_from_run_dir(run_dir: Path):
    """(model class, its config, best checkpoint path) from a training run
    directory of a composite: Franky (franky, moe-gpt) or FrankyLlama."""
    from frankenstein_tpu_torch.config import FrankyConfig, FrankyLlamaConfig
    from frankenstein_tpu_torch.models.franky import Franky, FrankyLlama
    from frankenstein_tpu_torch.train import checkpoints as ckpt_lib

    doc = json.loads((Path(run_dir) / "model_config.json").read_text())
    composites = {"franky": (Franky, FrankyConfig),
                  "moe-gpt": (Franky, FrankyConfig),
                  "franky-llama": (FrankyLlama, FrankyLlamaConfig)}
    if doc["model"] not in composites:
        raise SystemExit(f"--run-dir decoding serves the composite models "
                         f"(franky, franky-llama and moe-gpt), not "
                         f"{doc['model']}")
    cls, cfg_cls = composites[doc["model"]]
    best = ckpt_lib.best_checkpoint(run_dir)
    if best is None:
        raise SystemExit(f"no step_*_loss_* checkpoint under {run_dir}")
    return cls, cfg_cls.from_dict(doc["model_config"]), best


def main(argv=None) -> Path:
    """Run the CLI; returns the path of the written file."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--data", required=True,
                    help="competitionData root, or 'synthetic'")
    ap.add_argument("--split", default="test")
    ap.add_argument("--run-dir", default=None,
                    help="training run dir (model_config.json + "
                         "checkpoints)")
    ap.add_argument("--checkpoint", default=None,
                    help="step_*_loss_* dir; defaults to the run dir's best")
    ap.add_argument("--out", default="sub.txt")
    ap.add_argument("--beam-width", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--synthetic-trials", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; exits without a usable GPU) or cpu")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from frankenstein_tpu_torch.parallel import mesh as mesh_lib
    from frankenstein_tpu_torch.utils.device import cli_device

    device = cli_device(args.device)
    joined = not dist.is_initialized()
    mesh_lib.maybe_initialize_distributed(device.type)
    joined = joined and dist.is_initialized()
    try:
        if device.type == "cuda" and dist.is_initialized():
            device = torch.device("cuda", torch.cuda.current_device())
        return _serve(args, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _serve(args, device) -> Path:
    import torch.distributed as dist

    from frankenstein_tpu_torch.config import FrankyConfig
    from frankenstein_tpu_torch.data import datasets, tokenizers
    from frankenstein_tpu_torch.decode.pipeline import (
        cast_params_for_inference, make_franky_predictor)
    from frankenstein_tpu_torch.eval.submission import (create_string_file,
                                                        make_predictions)
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.train import checkpoints as ckpt_lib

    ckpt = Path(args.checkpoint) if args.checkpoint else None
    if args.run_dir:
        cls, cfg, best = build_from_run_dir(Path(args.run_dir))
        ckpt = ckpt or best
    elif ckpt is None:
        raise SystemExit("pass --run-dir or --checkpoint")
    else:
        cls, cfg = Franky, FrankyConfig()
    model = cls(cfg, device=device)
    model.load_state_dict(ckpt_lib.load_raw_checkpoint(
        ckpt, map_location=device)["model"])
    model = cast_params_for_inference(model)

    enc = cfg.brain.encoder
    tok = tokenizers.best_available_tokenizer()
    if args.data == "synthetic":
        ds = datasets.BrainDataset.synthetic(
            n_trials=args.synthetic_trials, seed=2,
            n_electrodes=enc.n_electrodes, max_input_len=enc.window_size)
    else:
        ds = datasets.BrainDataset(
            Path(args.data) / args.split,
            tokenize_function=tokenizers.get_tokenizer(tok),
            max_input_len=enc.window_size)
    predict = make_franky_predictor(model, tok, max_new_tokens=cfg.max_tokens,
                                    beam_width=args.beam_width)
    group = dist.group.WORLD if dist.is_initialized() else None
    sentences = make_predictions(ds, predict, batch_size=args.batch_size,
                                 group=group)
    out = Path(args.out)
    if group is None or dist.get_rank() == 0:
        out = create_string_file(args.out, sentences)
        print(f"wrote {len(sentences)} predictions to {out}")
    return out


if __name__ == "__main__":
    main()
