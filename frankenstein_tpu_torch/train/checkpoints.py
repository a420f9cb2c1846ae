"""Checkpoints: model + optimizer state + step
(``frankenstein_tpu/train/checkpoints.py``).

Each checkpoint is a ``step_{N}_loss_{L:.4f}/`` directory holding
``state.pt`` (``torch.save`` of ``{"model", "optimizer", "step"}``) and
``META.json`` (``{"step", "val_loss"}``), named and retained as the JAX
package does: the ``keep`` best by validation loss (or by the trainer's
``eval_metric``) survive.
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
                    keep: int = 3) -> Path:
    """Write ``state`` (a ``trainer.TrainState``), then drop all but the
    ``keep`` best checkpoints. META.json is written last, so a directory
    without it is an unfinished checkpoint and is never picked."""
    save_dir = Path(save_dir)
    path = (save_dir / _ckpt_name(step, val_loss)).absolute()
    if path.exists():          # stale dir from an interrupted/previous run
        shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(step)}, path / STATE_FILE)
    (path / "META.json").write_text(json.dumps(
        {"step": int(step), "val_loss": float(val_loss)}))
    for _, d in sorted(_scored(save_dir), key=lambda t: t[0])[keep:]:
        shutil.rmtree(d, ignore_errors=True)
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
    """Warm-start a composite's encoder from an MAE checkpoint. The MAE is
    not ported yet, so no port checkpoint holds one."""
    raise NotImplementedError(
        "graft_encoder_from_mae: the MAE is not ported yet, so there is no "
        "MAE checkpoint to graft (ROADMAP.md, modules to port, item 8)")
