"""Checkpoints: model + optimizer state + step
(``frankenstein_tpu/train/checkpoints.py``).

Each checkpoint is a ``step_{N}_loss_{L:.4f}/`` directory holding
``state.pt`` (``torch.save`` of ``{"model", "optimizer", "step"}``; the
model's state dict holds its buffers, a SoundStream's codebook among
them) and ``META.json`` (``{"step", "val_loss"}``), named and retained as
the JAX package does: the ``keep`` best by validation loss (or by the
trainer's ``eval_metric``) survive.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

import torch

STATE_FILE = "state.pt"


def _ckpt_name(step: int, loss: float) -> str:
    return f"step_{step}_loss_{loss:.4f}"


def _scored(save_dir: Path):
    """(val_loss, dir) of every finished checkpoint under ``save_dir``."""
    out = []
    for d in Path(save_dir).glob("step_*_loss_*"):
        meta = d / "META.json"
        if meta.exists():
            out.append((json.loads(meta.read_text())["val_loss"], d))
    return out


def save_checkpoint(save_dir: Path, state, step: int, val_loss: float,
                    keep: int = 3, payload: Optional[dict] = None,
                    write: bool = True) -> Optional[Path]:
    """Write ``state`` (a ``trainer.TrainState``), or ``payload`` (its
    gathered ``{"model", "optimizer"}`` full state dicts on a sharded run),
    then drop all but the ``keep`` best checkpoints; ``write`` False (a
    rank other than the first) writes nothing and returns None. META.json
    is written last, so a directory without it is an unfinished checkpoint
    and is never picked."""
    if not write:
        return None
    save_dir = Path(save_dir)
    if payload is None:
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict()}
    path = _write(save_dir, payload, step, val_loss)
    for _, d in sorted(_scored(save_dir), key=lambda t: t[0])[keep:]:
        shutil.rmtree(d, ignore_errors=True)
    return path


def save_weights(save_dir: Path, model_state: dict, step: int,
                 val_loss: float) -> Path:
    """A checkpoint of weights alone, in ``save_checkpoint``'s layout with
    no optimizer state (``state.pt`` holds ``{"model", "step"}``): what
    ``convert_reference`` writes for a reference file. It serves and
    grafts; ``restore_checkpoint`` needs a trainer's checkpoint."""
    return _write(Path(save_dir), {"model": model_state}, step, val_loss)


def _write(save_dir: Path, payload: dict, step: int, val_loss: float) -> Path:
    path = (save_dir / _ckpt_name(step, val_loss)).absolute()
    if path.exists():          # stale dir from an interrupted/previous run
        shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    torch.save({**payload, "step": int(step)}, path / STATE_FILE)
    (path / "META.json").write_text(json.dumps(
        {"step": int(step), "val_loss": float(val_loss)}))
    return path


def best_checkpoint(save_dir: Path) -> Optional[Path]:
    scored = _scored(save_dir)
    return min(scored, key=lambda t: t[0])[1] if scored else None


def load_raw_checkpoint(path: Path, map_location="cpu") -> dict:
    """The saved dict ``{"model", "optimizer", "step"}``. ``path`` may be a
    concrete ``step_*_loss_*`` directory or a run directory holding several
    (the best by validation loss is picked)."""
    path = Path(path)
    if not (path / "META.json").exists():
        best = best_checkpoint(path)
        if best is None:
            raise FileNotFoundError(
                f"no step_*_loss_* checkpoint under {path}")
        path = best
    return torch.load(path / STATE_FILE, map_location=map_location,
                      weights_only=True)


def restore_checkpoint(path: Path, state):
    """Load a checkpoint into ``state`` (model, optimizer, step) in place;
    returns ``state``. Read to host memory first: ``load_state_dict`` puts
    every tensor where its parameter lives, and keeps AdamW's step counts
    on the host, where the optimizer wants them."""
    raw = load_raw_checkpoint(path)
    state.model.load_state_dict(raw["model"])
    state.optimizer.load_state_dict(raw["optimizer"])
    state.step = int(raw["step"])
    return state


def graft_encoder_from_mae(ckpt_path: Path, model):
    """Warm-start a composite's encoder from an MAE checkpoint: copy its
    ``encoder.*`` tensors into ``model.brain_model.encoder`` (Franky and
    FrankyLlama hold the same ``Encoder(MAEConfig)`` there), in place;
    returns ``model``.

    ``ckpt_path`` may be a concrete ``step_*_loss_*`` directory or a train
    CLI run directory, which resolves to its best checkpoint
    (``load_raw_checkpoint``), so ``--init-encoder-from logs/<mae run>``
    works as it is. A composite checkpoint's ``brain_model.encoder.*``
    works too. Differing key sets or shapes (another ``MAEConfig``) raise
    instead of silently training cold."""
    state = load_raw_checkpoint(ckpt_path)["model"]
    for prefix in ("encoder.", "brain_model.encoder."):
        src = {k[len(prefix):]: v for k, v in state.items()
               if k.startswith(prefix)}
        if src:
            break
    else:
        raise ValueError(f"checkpoint {ckpt_path} has no encoder tensors "
                         f"(keys: {sorted(state)[:8]}...)")
    if not hasattr(model, "brain_model"):
        raise ValueError(f"target {type(model).__name__} is not a Franky or "
                         "FrankyLlama model")
    encoder = model.brain_model.encoder
    tgt = encoder.state_dict()
    if set(src) != set(tgt):
        raise ValueError(
            "encoder tensors differ: "
            f"only-in-ckpt={sorted(set(src) - set(tgt))}, "
            f"only-in-model={sorted(set(tgt) - set(src))}")
    for name, value in src.items():
        if tuple(value.shape) != tuple(tgt[name].shape):
            raise ValueError(
                f"encoder geometry mismatch at {name}: checkpoint "
                f"{tuple(value.shape)} vs model {tuple(tgt[name].shape)} "
                "- MAEConfig must match the composite's brain encoder")
    encoder.load_state_dict({name: value.to(tgt[name].dtype)
                             for name, value in src.items()}, strict=True)
    return model
