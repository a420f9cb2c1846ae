"""Convert a reference checkpoint file into a checkpoint of the port, and
back (the port of ``examples/convert_reference_checkpoint.py``).

The reference trains torch modules and saves ``state_dict()`` tensors as
``.safetensors``. The port's modules carry the reference's names and
layouts, so the conversion is a strict load into the kind's module at its
config's default geometry (``--n-sessions`` adds the port's session
embedding, zero rows, a numeric no-op) and a checkpoint written in
``train/checkpoints.py``'s layout with no optimizer state:

    python -m frankenstein_tpu_torch.convert_reference --kind franky \\
        --src step_5000_loss_3.1739.safetensors --dst runs/franky_ref
    python -m frankenstein_tpu_torch.submit --checkpoint runs/franky_ref \\
        --data synthetic

    # back to the reference's file
    python -m frankenstein_tpu_torch.convert_reference --kind franky \\
        --reverse --src runs/franky_ref --dst franky.safetensors

``--dst`` is a run directory: it gets ``model_config.json`` and one
``step_0_loss_nan/`` checkpoint (no loss was evaluated), so both
``--checkpoint`` and, for the composites, ``--run-dir`` find it. Kinds:
encoder | mae | brain_encoder | gpt | franky | simple_mae | soundstream.
Loading runs on the CPU; the file is read by the port's own reader
(``models/import_reference.py``), ``.safetensors`` or a torch pickle.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

KINDS = ("encoder", "mae", "brain_encoder", "gpt", "franky", "simple_mae",
         "soundstream")


def build(kind: str, sd: dict = None, n_sessions: int = 0):
    """(model config name, config, module) of ``kind`` at its default
    geometry; a brain_encoder's head is the one ``sd`` holds (``to_words``,
    the Franky notebook's, or ``to_motion``, BrainFormer's)."""
    from frankenstein_tpu_torch import config as cfg_lib
    from frankenstein_tpu_torch.models import brainformer, gpt2
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.models.simple_mae import SimpleMAE
    from frankenstein_tpu_torch.models.vq_brain import SoundStream

    enc = cfg_lib.MAEConfig(n_sessions=n_sessions)
    if kind == "encoder":
        return "encoder", enc, brainformer.Encoder(enc)
    if kind == "mae":
        return "mae", enc, brainformer.MAE(enc)
    if kind == "brain_encoder":
        cfg = cfg_lib.PerceiverConfig(encoder=enc)
        head = ("to_motion" if sd is not None
                and "perceiver.to_motion.weight" in sd else "to_words")
        return "brain_encoder", cfg, brainformer.BrainEncoder(cfg, head=head)
    if kind == "gpt":
        cfg = cfg_lib.GPTConfig()
        return "gpt", cfg, gpt2.GPT(cfg)
    if kind == "franky":
        base = cfg_lib.FrankyConfig()
        cfg = base.replace(brain=base.brain.replace(
            encoder=base.brain.encoder.replace(n_sessions=n_sessions)))
        return "franky", cfg, Franky(cfg)
    if kind == "simple_mae":
        cfg = (cfg_lib.SimpleEncoderConfig(), cfg_lib.SimpleMAEConfig())
        return "simple_mae", cfg, SimpleMAE(*cfg)
    if kind == "soundstream":
        cfg = cfg_lib.VQVAEConfig()
        return "vqvae", cfg, SoundStream(cfg)
    raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")


def _session_rows(model) -> dict:
    """Zero rows for every session embedding of ``model``: the reference
    has none, and a zero row adds nothing."""
    import torch
    return {name: torch.zeros_like(t) for name, t in
            model.state_dict().items() if name.endswith("date_embedding")}


def import_file(kind: str, src, dst, n_sessions: int = 0) -> Path:
    """Load the reference file ``src`` strictly into ``kind``'s module and
    write it as a checkpoint under the run directory ``dst``; returns the
    checkpoint's path."""
    from frankenstein_tpu_torch.models import import_reference as ir
    from frankenstein_tpu_torch.models.weights import load_strict
    from frankenstein_tpu_torch.train import checkpoints as ckpt_lib

    sd = ir.load_state_dict(src)
    if kind == "soundstream":
        sd = ir.soundstream_state(sd)
    name, cfg, model = build(kind, sd, n_sessions)
    load_strict(model, {**_session_rows(model), **sd})
    dst = Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    mc = ([c.to_dict() for c in cfg] if isinstance(cfg, tuple)
          else cfg.to_dict())
    (dst / "model_config.json").write_text(json.dumps(
        {"model": name, "model_config": mc}, indent=1))
    return ckpt_lib.save_weights(dst, model.state_dict(), 0, float("nan"))


def export_checkpoint(src, dst) -> int:
    """Write the model of checkpoint ``src`` (a ``step_*_loss_*`` directory
    or a run directory) as a reference ``.safetensors`` file ``dst``,
    without the port's session embedding; returns the tensor count."""
    from frankenstein_tpu_torch.models import import_reference as ir
    from frankenstein_tpu_torch.train import checkpoints as ckpt_lib

    state = ckpt_lib.load_raw_checkpoint(Path(src))["model"]
    sd = {k: v for k, v in state.items()
          if not k.endswith("date_embedding")}
    ir.save_state_dict(sd, dst)
    return len(sd)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--kind", required=True, choices=KINDS)
    ap.add_argument("--src", required=True,
                    help="import: a .safetensors / .pt file; --reverse: a "
                         "checkpoint or run directory")
    ap.add_argument("--dst", required=True,
                    help="import: a run directory; --reverse: a "
                         ".safetensors file")
    ap.add_argument("--reverse", action="store_true",
                    help="write the port's checkpoint as a reference file")
    ap.add_argument("--n-sessions", type=int, default=0,
                    help="zero session-embedding rows for this many "
                         "sessions (the port's extension; reference files "
                         "have none)")
    args = ap.parse_args(argv)
    if args.reverse:
        n = export_checkpoint(args.src, args.dst)
        print(f"exported {args.kind}: {n} tensors -> {args.dst}")
        return Path(args.dst)
    path = import_file(args.kind, args.src, args.dst, args.n_sessions)
    print(f"imported {args.kind} -> {path}")
    return path


if __name__ == "__main__":
    main()
