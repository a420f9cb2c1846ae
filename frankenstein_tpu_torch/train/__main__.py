"""Train the flagship Franky (with a dense or an MoE GPT) or FrankyLlama,
pretrain an encoder as an MAE or a SimpleMAE, or train the VQ-VAE
tokenizer (the port of ``train.py --model franky``, ``moe-gpt``,
``franky-llama``, ``mae``, ``simple_mae`` and ``vqvae``).

Examples:
  # end-to-end Franky on synthetic data (no dataset needed)
  python -m frankenstein_tpu_torch.train --config configs/franky.yaml \\
      --data synthetic --steps 50 --batch-size 32

  # MAE pretraining, then Franky with the pretrained encoder grafted in
  python -m frankenstein_tpu_torch.train --config configs/mae.yaml \\
      --data synthetic --steps 50 --batch-size 32 --exp-name mae
  python -m frankenstein_tpu_torch.train --config configs/franky.yaml \\
      --data synthetic --init-encoder-from logs/mae

  # the north-star composite (its YAML, or --model franky-llama with the
  # geometry flags), grafted the same way
  python -m frankenstein_tpu_torch.train --config configs/franky_llama.yaml \\
      --data synthetic --init-encoder-from logs/mae

  # SimpleMAE over whole-timestep tokens: --channels is the token width
  python -m frankenstein_tpu_torch.train --model simple_mae \\
      --window 768 --channels 256 --data synthetic

  # the VQ-VAE tokenizer (SoundStream) over 512 channels, from its YAML
  # or by flags (--channels, --window)
  python -m frankenstein_tpu_torch.train --config configs/vqvae.yaml \\
      --data synthetic --steps 50 --batch-size 64
  python -m frankenstein_tpu_torch.train --model vqvae --channels 512 \\
      --window 768 --data synthetic

  # the flagship with a top-2 MoE of 8 experts in every GPT block (its
  # YAML, or --model moe-gpt with --moe-experts / --moe-k / --moe-capacity);
  # the YAML's mesh (2, 4) needs 8 ranks, so one card runs it with --mesh 1,1
  python -m frankenstein_tpu_torch.train --config configs/moe_gpt.yaml \\
      --mesh 1,1 --data synthetic --steps 50 --batch-size 32
  # over 8 cards: data 2 x experts 4
  torchrun --nproc_per_node 8 -m frankenstein_tpu_torch.train \\
      --config configs/moe_gpt.yaml --data synthetic

  # on the competition data; then serve the run
  python -m frankenstein_tpu_torch.train --config configs/franky.yaml \\
      --data /data/competitionData --exp-name franky
  python -m frankenstein_tpu_torch.submit --run-dir logs/franky \\
      --data /data/competitionData

With ``--config`` the YAML's ``train`` section is the base and only the
flags typed on the command line override it. The run directory
(``<save-folder>/<exp-name>``) gets ``model_config.json``,
``train_config.json``, ``metrics.jsonl`` (with ``mfu`` on a card whose
peak ``utils/profiling.py`` knows, and the VQ-VAE's perplexity, rec_loss
and commit_loss) and ``step_*_loss_*`` checkpoints.
The model trains on the GPU (``--device cuda``, the default; without a
usable GPU the CLI exits) or, when asked, on the CPU (``--device cpu``):
f32 parameters, bf16 compute unless ``--no-bf16``.

Under torchrun (or any ``MASTER_ADDR`` / ``WORLD_SIZE`` environment) the
ranks join one process group, NCCL on the cards (each rank on the card
``LOCAL_RANK`` names) or gloo with ``--device cpu``, and train over the
``--mesh d,m`` (data, model) mesh, all ranks on "data" by default, with
FSDP when the YAML's ``fsdp`` is set (``train/trainer.py``). A mesh whose
size is not the number of ranks exits with the cause. Rank 0 writes the
run directory.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# models the JAX package's train.py accepts but cannot train: the port
# refuses them with the fault (ROADMAP.md, "Findings in the JAX package")
JAX_FINDINGS = {
    "brainformer": (
        "the JAX trainer passes the batch's token ids [B, 25] as "
        "BrainFormer's targets (frankenstein_tpu/train/trainer.py:125-131), "
        "but its L1 head takes float targets of the prediction's shape "
        "[B, 25, 50257] (frankenstein_tpu/models/brainformer.py:258-273): "
        "train.py --model brainformer fails with \"ValueError: Incompatible "
        "shapes for broadcasting: (2, 25, 50257), (2, 25)\". "
        "models/brainformer.py:BrainFormer serves callers with float "
        "targets"),
}
SIMPLE_MAE_FINDING = (
    "The JAX train.py takes no data geometry from a simple_mae YAML "
    "(train.py:145-153), so such a YAML fails in its loss "
    "(configs/simple_mae.yaml, patch_size 128 against 256 channels: "
    "\"TypeError: sub got incompatible shapes (2, 576, 128), "
    "(2, 576, 256)\"). Pass --channels equal to encoder.patch_size, or "
    "train by flags")

# CLI flag -> TrainConfig field, for flags that override the YAML
FLAG_TO_FIELD = {
    "exp_name": "exp_name", "batch_size": "batch_size",
    "grad_accum": "grad_accum", "steps_per_dispatch": "steps_per_dispatch",
    "lr": "learning_rate", "weight_decay": "weight_decay",
    "wd_mask": "weight_decay_mask", "p_augs": "p_augs", "steps": "max_steps",
    "eval_interval": "eval_interval", "warmup": "warmup_iters",
    "decay_iters": "lr_decay_iters", "bf16": "mixed_precision",
    "no_bf16": "mixed_precision", "mesh": "mesh_shape"}
TRAINED = ("franky", "moe-gpt", "franky-llama", "mae", "simple_mae", "vqvae")
COMPOSITES = ("franky", "moe-gpt", "franky-llama")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default=None,
                   help="YAML config (see configs/); explicitly passed CLI "
                        "flags override its train section")
    p.add_argument("--model", default="franky",
                   choices=[*TRAINED, *JAX_FINDINGS])
    p.add_argument("--moe-experts", type=int, default=8,
                   help="expert count for --model moe-gpt")
    p.add_argument("--moe-k", type=int, default=2,
                   help="experts routed per token for --model moe-gpt")
    p.add_argument("--moe-capacity", type=float, default=1.25,
                   help="expert capacity factor for --model moe-gpt "
                        "(tokens over cap are dropped; the residual "
                        "carries them)")
    p.add_argument("--data", default="synthetic",
                   help="'synthetic' or path to competitionData/")
    p.add_argument("--exp-name", default=None)
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="optimizer steps per host group (no host read "
                        "inside a group; same numerics as single steps)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-5)
    p.add_argument("--wd-mask", action="store_true",
                   help="decay only ndim>=2 params (nanoGPT grouping)")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="GPT dropout rate (without --config)")
    p.add_argument("--p-augs", type=float, default=0.0,
                   help="per-sample probability of time-mask augmentation")
    p.add_argument("--eval-interval", type=int, default=1000)
    p.add_argument("--warmup", type=int, default=2000)
    p.add_argument("--decay-iters", type=int, default=50_000)
    p.add_argument("--window", type=int, default=768,
                   help="time bins a window (simple_mae: its tokens; "
                        "vqvae: also with --config)")
    p.add_argument("--patch", type=int, default=32)
    p.add_argument("--channels", type=int, default=256,
                   help="electrodes (simple_mae: a token's width; "
                        "vqvae: its n_electrodes)")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--synthetic-trials", type=int, default=512)
    p.add_argument("--save-folder", default="logs")
    p.add_argument("--init-encoder-from", default=None, metavar="CKPT",
                   help="graft an MAE checkpoint's encoder into Franky or "
                        "FrankyLlama before training (a run dir resolves "
                        "to its best checkpoint; the MAEConfig geometry "
                        "must match)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; exits without a usable GPU) or cpu")
    p.add_argument("--mesh", default=None,
                   help="data,model mesh shape; its size must be the number "
                        "of ranks (one without torchrun)")
    return p.parse_args(argv)


def _refuse(name: str):
    raise SystemExit(f"--model {name} is refused: {JAX_FINDINGS[name]}")


def _config_from_yaml(name: str, mc: dict):
    from frankenstein_tpu_torch import config as cfg_lib
    if name == "simple_mae":
        return (cfg_lib.SimpleEncoderConfig.from_dict(mc.get("encoder", {})),
                cfg_lib.SimpleMAEConfig.from_dict(mc.get("decoder", {})))
    return {"franky": cfg_lib.FrankyConfig, "mae": cfg_lib.MAEConfig,
            "moe-gpt": cfg_lib.FrankyConfig,
            "franky-llama": cfg_lib.FrankyLlamaConfig,
            "vqvae": cfg_lib.VQVAEConfig}[name].from_dict(mc)


def _config_from_flags(args):
    from frankenstein_tpu_torch import config as cfg_lib
    if args.model == "simple_mae":
        return (cfg_lib.SimpleEncoderConfig(block_size=args.window,
                                            patch_size=args.channels),
                cfg_lib.SimpleMAEConfig())
    if args.model == "vqvae":
        return cfg_lib.VQVAEConfig(n_electrodes=args.channels)
    enc = cfg_lib.MAEConfig(window_size=args.window,
                            n_electrodes=args.channels, patch_size=args.patch)
    if args.model == "mae":
        return enc
    if args.model == "franky-llama":
        return cfg_lib.FrankyLlamaConfig(brain=cfg_lib.PerceiverConfig(
            encoder=enc, n_output_tokens=32, output_dim=1024))
    moe = args.moe_experts if args.model == "moe-gpt" else 0
    return cfg_lib.FrankyConfig(
        brain=cfg_lib.PerceiverConfig(encoder=enc, n_output_tokens=32,
                                      output_dim=768),
        gpt=cfg_lib.GPTConfig(dropout=args.dropout, moe_experts=moe,
                              moe_k=args.moe_k,
                              moe_capacity=args.moe_capacity))


def model_config(args):
    """(model config, YAML train section or None) from --config or the
    flags: a FrankyConfig (franky, moe-gpt), FrankyLlamaConfig, MAEConfig
    or VQVAEConfig, or SimpleMAE's (SimpleEncoderConfig,
    SimpleMAEConfig)."""
    if args.config:
        import yaml
        doc = yaml.safe_load(Path(args.config).read_text())
        args.model = doc["model"]
        if args.model not in TRAINED:
            _refuse(args.model)
        return (_config_from_yaml(args.model, doc.get("model_config", {})),
                doc.get("train", {}))
    if args.model not in TRAINED:
        _refuse(args.model)
    return _config_from_flags(args), None


def data_geometry(args, cfg) -> tuple:
    """(window, channels) of the data: the encoder's for the MAE and the
    composites; for the VQ-VAE the --window flag and the config's
    electrodes (a YAML gives no window, as in the JAX train.py); for
    SimpleMAE the flags', which its config must match (a token is one
    timestep of all channels)."""
    if args.model == "mae":
        return cfg.window_size, cfg.n_electrodes
    if args.model == "vqvae":
        return args.window, cfg.n_electrodes
    if args.model != "simple_mae":
        return cfg.brain.encoder.window_size, cfg.brain.encoder.n_electrodes
    enc = cfg[0]
    if enc.patch_size != args.channels:
        raise SystemExit(
            f"--model simple_mae: encoder.patch_size {enc.patch_size} is "
            f"not the data's channel count {args.channels}. "
            f"{SIMPLE_MAE_FINDING}")
    if enc.block_size < args.window:
        raise SystemExit(
            f"--model simple_mae: encoder.block_size {enc.block_size} is "
            f"shorter than the data's window {args.window}")
    return args.window, args.channels


def train_config(args, yaml_train, argv):
    """TrainConfig: the YAML section as the base and the typed flags over
    it, or the flags alone without --config."""
    from frankenstein_tpu_torch.config import TrainConfig
    mesh = (tuple(int(s) for s in args.mesh.split(",")) if args.mesh
            else None)
    cli = dict(
        exp_name=args.exp_name or f"{args.model}_{args.data.split('/')[-1]}",
        batch_size=args.batch_size, grad_accum=args.grad_accum,
        steps_per_dispatch=args.steps_per_dispatch, learning_rate=args.lr,
        weight_decay=args.weight_decay, weight_decay_mask=args.wd_mask,
        p_augs=args.p_augs, max_steps=args.steps,
        eval_interval=args.eval_interval, warmup_iters=args.warmup,
        lr_decay_iters=args.decay_iters, mixed_precision=args.bf16,
        mesh_shape=mesh)
    if yaml_train is None:
        return TrainConfig(**cli)
    typed = {a.split("=")[0].lstrip("-").replace("-", "_")
             for a in argv if a.startswith("--")}
    overrides = {field: cli[field] for flag, field in FLAG_TO_FIELD.items()
                 if flag in typed}
    if "exp_name" not in yaml_train and "exp_name" not in overrides:
        overrides["exp_name"] = cli["exp_name"]
    return TrainConfig.from_dict(yaml_train).replace(**overrides)


def build_datasets(data: str, window: int, channels: int,
                   synthetic_trials: int):
    """(train, val): synthetic trials, or competitionData's train/ and
    test/."""
    from frankenstein_tpu_torch.data import datasets, tokenizers
    tok_fn = tokenizers.get_tokenizer(tokenizers.best_available_tokenizer())
    if data == "synthetic":
        kw = dict(tokenize_function=tok_fn, n_electrodes=channels,
                  max_input_len=window)
        return (datasets.BrainDataset.synthetic(n_trials=synthetic_trials,
                                                seed=0, **kw),
                datasets.BrainDataset.synthetic(
                    n_trials=max(synthetic_trials // 8, 8), seed=1, **kw))
    root = Path(data)
    return tuple(datasets.BrainDataset(root / split, tokenize_function=tok_fn,
                                       max_input_len=window)
                 for split in ("train", "test"))


def build_model(args, cfg, tcfg, device):
    """The model from ``cfg`` with random weights from the config's seed,
    f32 parameters with bf16 compute unless --no-bf16; a composite's
    encoder grafted from --init-encoder-from when given."""
    import torch

    from frankenstein_tpu_torch.models import weights
    from frankenstein_tpu_torch.models.brainformer import MAE
    from frankenstein_tpu_torch.models.franky import Franky, FrankyLlama
    from frankenstein_tpu_torch.models.simple_mae import SimpleMAE
    from frankenstein_tpu_torch.models.vq_brain import SoundStream
    from frankenstein_tpu_torch.train import checkpoints

    dtype = torch.bfloat16 if tcfg.mixed_precision else None
    if args.model == "vqvae":
        return weights.init_soundstream_(
            SoundStream(cfg, device=device, dtype=dtype), seed=tcfg.seed)
    if args.model == "mae":
        return weights.init_mae_(MAE(cfg, device=device, dtype=dtype),
                                 seed=tcfg.seed)
    if args.model == "simple_mae":
        return weights.init_simple_mae_(
            SimpleMAE(*cfg, device=device, dtype=dtype), seed=tcfg.seed)
    if args.model == "franky-llama":
        model = weights.init_franky_llama_(
            FrankyLlama(cfg, device=device, dtype=dtype), seed=tcfg.seed)
    else:
        model = weights.init_franky_(Franky(cfg, device=device, dtype=dtype),
                                     seed=tcfg.seed)
    if args.init_encoder_from:
        checkpoints.graft_encoder_from_mae(args.init_encoder_from, model)
    return model


def flops_per_sample(name: str, cfg, window: int) -> float:
    """A sample's forward FLOPs (``utils/profiling.py``) for the trainer's
    MFU, for the models the JAX train.py gives one: franky, franky-llama,
    mae and vqvae (moe-gpt: Franky's formula, as the JAX train.py gives
    it); 0 (no MFU) for simple_mae."""
    from frankenstein_tpu_torch.utils import profiling
    if name in ("franky", "moe-gpt"):
        return profiling.franky_fwd_flops_per_sample(cfg)
    if name == "franky-llama":
        return profiling.franky_llama_fwd_flops_per_sample(cfg)
    if name == "mae":
        return profiling.mae_fwd_flops_per_sample(cfg)
    if name == "vqvae":
        return profiling.vqvae_fwd_flops_per_sample(cfg, t=window)
    return 0.0


def main(argv=None):
    """Run the CLI; returns the final ``trainer.TrainState``."""
    import torch
    import torch.distributed as dist

    from frankenstein_tpu_torch.parallel import mesh as mesh_lib
    from frankenstein_tpu_torch.train.trainer import run_train_model
    from frankenstein_tpu_torch.utils.device import cli_device

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    cfg, yaml_train = model_config(args)
    if args.init_encoder_from and args.model not in COMPOSITES:
        raise SystemExit(
            f"--init-encoder-from grafts an MAE encoder into a composite: "
            f"--model franky, moe-gpt or franky-llama, not {args.model}")
    window, channels = data_geometry(args, cfg)
    tcfg = train_config(args, yaml_train, argv)
    device = cli_device(args.device)
    joined = not dist.is_initialized()
    world = mesh_lib.maybe_initialize_distributed(device.type)
    joined = joined and dist.is_initialized()
    try:
        shape = tcfg.mesh_shape or (world, 1)
        if shape[0] * shape[1] != world:
            raise SystemExit(
                f"--mesh {shape[0]},{shape[1]} needs {shape[0] * shape[1]} "
                f"ranks, this run has {world} (torchrun --nproc_per_node "
                f"{shape[0] * shape[1]}, or --mesh 1,1 on one device)")
        if device.type == "cuda" and dist.is_initialized():
            device = torch.device("cuda", torch.cuda.current_device())
        data = build_datasets(args.data, window, channels,
                              args.synthetic_trials)
        model = build_model(args, cfg, tcfg, device)

        save = Path(args.save_folder)
        run_dir = save / tcfg.exp_name
        if not dist.is_initialized() or dist.get_rank() == 0:
            run_dir.mkdir(parents=True, exist_ok=True)
            # the model config beside the run, so the submission CLI
            # rebuilds it (SimpleMAE's two sections as a list, as the JAX
            # train.py writes them)
            mc = ([c.to_dict() for c in cfg] if isinstance(cfg, tuple)
                  else cfg.to_dict())
            (run_dir / "model_config.json").write_text(json.dumps(
                {"model": args.model, "model_config": mc}, indent=1))
        state = run_train_model(
            model, data, tcfg, save_folder=save,
            flops_per_sample=flops_per_sample(args.model, cfg, window))
        print(f"done at step {state.step}; logs in {run_dir}")
        return state
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
