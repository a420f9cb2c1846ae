"""Training runtime (``frankenstein_tpu/train/trainer.py``): AdamW with a
value clip and the warmup-cosine schedule, grad accumulation, f32 parameters
with bf16 compute, periodic eval, best-by-metric checkpoints, resume, JSONL
metrics and a stop on a non-finite loss.

The model contract is the JAX package's uniform one: ``loss, logits =
model(x, targets, train=..., generator=..., date_info=...)``, where
``date_info`` is the batch's third array (the samples' session ids) and
``targets`` is None for a model whose ``needs_labels`` is False (the MAE,
SimpleMAE, SoundStream), plus a ``remat`` attribute that the trainer sets
from the config (``models/franky.py:Franky``). A model may leave ``aux``,
a dict of scalar tensors, after its forward (SoundStream's perplexity,
rec_loss and commit_loss, the JAX package's sown ``"aux"``); the trainer
logs each, the mean over the microbatches under grad accumulation.

On one device, in eager PyTorch:
- a step is ``grad_accum`` forward/backward passes over equal microbatches
  (mean loss, mean gradients), a value clip, one AdamW update; buffers a
  forward writes (SoundStream's codebook) carry from one microbatch to the
  next, as the JAX scan threads its mutable collections;
- ``steps_per_dispatch`` = k runs k such steps per host group with no host
  read between them; the numerics are those of k single steps and a run
  stops at most k - 1 steps past ``max_steps`` (CUDA graphs over the group
  are later work);
- randomness (augmentation, dropout, the MAE's mask) comes from one
  ``torch.Generator`` on the model's device, reseeded from (seed, step)
  before every step, so a step's draws do not depend on how the run got
  there (grouped steps, resume); an eval round reseeds it from (seed + 1,
  step) before each batch, so the MAE draws its eval mask as the JAX
  trainer does, from a key that does not change within the round;
- the loss is read to the host only at warm-up, log and eval boundaries and
  at the end, where a non-finite value raises ``FloatingPointError``;
- with ``flops_per_sample`` (forward FLOPs, ``utils/profiling.py``) and a
  card whose peak is known, each log line has ``mfu``: 3 x forward FLOPs a
  step over the step time and the peak, as the JAX package logs it.
Not ported: ``fsdp`` and meshes wider than one device (ROADMAP item
"parallel modes and MoE").
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from frankenstein_tpu_torch.config import TrainConfig
from frankenstein_tpu_torch.train.schedule import make_lr_schedule
from frankenstein_tpu_torch.utils import profiling
from frankenstein_tpu_torch.utils.metrics import MetricLogger


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0          # optimizer updates made so far

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_optimizer(config: TrainConfig, model: nn.Module):
    """(AdamW, schedule). AdamW takes (b1, b2) and eps 1e-8; every
    parameter decays, or with ``weight_decay_mask`` only those with
    ndim >= 2 (matmul weights and embeddings, not biases and norms), as two
    parameter groups. ``model.parameters()`` lists the tied ``wte`` once.
    The train step sets the lr from the schedule before each update and
    clips by value first (optax's ``clip`` then ``adamw``)."""
    sched = make_lr_schedule(config)
    params = list(model.parameters())
    if config.weight_decay_mask:
        groups = [{"params": [p for p in params if p.ndim >= 2]},
                  {"params": [p for p in params if p.ndim < 2],
                   "weight_decay": 0.0}]
    else:
        groups = [{"params": params}]
    opt = torch.optim.AdamW(groups, lr=sched(0),
                            betas=(config.adam_b1, config.adam_b2), eps=1e-8,
                            weight_decay=config.weight_decay)
    return opt, sched


def augment_batch(batch, generator: torch.Generator, p_augs: float,
                  mask_frac: float = 1 / 16):
    """SpecAugment-style time masking: with probability ``p_augs`` per
    sample, zero one random span of ``mask_frac`` of the time axis of
    batch[0] ([B, T, C]). Draws from ``generator`` (on the batch's
    device)."""
    x = batch[0]
    b, t = x.shape[0], x.shape[1]
    span = max(int(t * mask_frac), 1)
    apply = torch.rand(b, generator=generator, device=x.device) < p_augs
    start = torch.randint(0, t - span + 1, (b,), generator=generator,
                          device=x.device)
    ti = torch.arange(t, device=x.device)[None]
    in_span = (ti >= start[:, None]) & (ti < (start + span)[:, None])
    keep = ~(apply[:, None] & in_span)
    shaped = keep.reshape(keep.shape + (1,) * (x.ndim - 2))
    return (x * shaped.to(x.dtype),) + tuple(batch[1:])


def _loss(model, batch, *, train: bool, generator=None):
    """(the model's loss on ``batch`` = (x, targets[, date_info]), the
    ``aux`` scalars its forward left, or {})."""
    targets = batch[1] if getattr(model, "needs_labels", True) else None
    date_info = batch[2] if len(batch) > 2 else None
    loss, _ = model(batch[0], targets, train=train, generator=generator,
                    date_info=date_info)
    return loss, dict(getattr(model, "aux", {}))


def loss_and_grads(state: TrainState, batch, config: TrainConfig,
                   generator: Optional[torch.Generator] = None,
                   aux: Optional[dict] = None):
    """Mean loss over ``grad_accum`` equal microbatches of ``batch``, with
    the mean gradients left in the parameters' ``.grad`` and, when ``aux``
    is given, the model's mean aux scalars written into it. Applies the
    step's augmentation and bf16 input cast first. The microbatches run in
    order, each on the buffers the last one wrote."""
    if config.p_augs > 0.0:
        batch = augment_batch(batch, generator, config.p_augs)
    if config.mixed_precision:
        batch = tuple(a.to(torch.bfloat16) if a.is_floating_point() else a
                      for a in batch)
    accum = max(config.grad_accum, 1)
    n = batch[0].shape[0] // accum
    state.optimizer.zero_grad(set_to_none=True)
    total, aux_sum = None, {}
    for i in range(accum):
        micro = tuple(a[i * n:(i + 1) * n] for a in batch)
        loss, micro_aux = _loss(state.model, micro, train=True,
                                generator=generator)
        (loss / accum).backward()
        total = loss.detach() if total is None else total + loss.detach()
        for key, value in micro_aux.items():
            aux_sum[key] = aux_sum.get(key, 0.0) + value.detach()
    if aux is not None:
        aux.update({k: v / accum for k, v in aux_sum.items()})
    return total / accum


def apply_update(state: TrainState, config: TrainConfig, sched) -> None:
    """The update from the gradients in ``.grad``: clip by value, set the lr
    from the schedule at this update's index, AdamW, count the step."""
    torch.nn.utils.clip_grad_value_(state.model.parameters(),
                                    config.grad_clip)
    for group in state.optimizer.param_groups:
        group["lr"] = sched(state.step)
    state.optimizer.step()
    state.step += 1


def _step_seed(seed: int, step: int) -> int:
    return seed * 1_000_003 + step


def train_step(state: TrainState, batch, config: TrainConfig, sched,
               generator: torch.Generator):
    """One optimizer update in place. Returns (loss, {"grad_norm", and the
    model's aux}) as device tensors; the norm is of the gradients before
    the clip."""
    generator.manual_seed(_step_seed(config.seed, state.step))
    aux = {}
    loss = loss_and_grads(state, batch, config, generator, aux)
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    gnorm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    apply_update(state, config, sched)
    return loss, {"grad_norm": gnorm, **aux}


@torch.no_grad()
def eval_step(state: TrainState, batch,
              generator: Optional[torch.Generator] = None):
    """The loss of one eval batch; ``generator`` draws what the model
    draws in eval (the MAE's mask), Franky ignores it."""
    return _loss(state.model, batch, train=False, generator=generator)[0]


def _check_parallel(config: TrainConfig) -> None:
    if config.fsdp:
        raise NotImplementedError(
            "fsdp: parameter sharding is not ported yet (ROADMAP.md, "
            "modules to port, \"parallel modes and MoE\")")
    if config.mesh_shape and math.prod(config.mesh_shape) > 1:
        raise NotImplementedError(
            f"mesh_shape {config.mesh_shape}: the port trains on one device; "
            "the parallel modes are ROADMAP.md, modules to port, "
            "\"parallel modes and MoE\"")


def run_train_model(model: nn.Module, datasets, config: TrainConfig,
                    save_folder: Path = Path("logs"),
                    eval_metric: Optional[Callable] = None,
                    resume: bool = False,
                    flops_per_sample: float = 0.0) -> TrainState:
    """Step-based loop: infinite epochs over the train set, log every
    ``log_interval`` and eval every ``eval_interval`` steps, best
    checkpoint, stop at ``max_steps`` (overshoot < ``steps_per_dispatch``).
    The model trains where it lies (its parameters' device).

    ``eval_metric(state, step) -> float``: when given, checkpoints are
    selected by it (lower is better) instead of the val loss. ``resume``
    restarts from the best checkpoint in the run directory, optimizer state
    and step included. ``flops_per_sample``, a sample's forward FLOPs,
    turns on the ``mfu`` metric where the card's peak is known."""
    from frankenstein_tpu_torch.data.datasets import batch_iterator
    from frankenstein_tpu_torch.data.loader import (prefetch, stack_steps,
                                                    to_device)
    from frankenstein_tpu_torch.train import checkpoints as ckpt_lib

    _check_parallel(config)
    train_ds, val_ds = datasets
    save_dir = Path(save_folder) / config.exp_name
    save_dir.mkdir(parents=True, exist_ok=True)
    (save_dir / "train_config.json").write_text(config.to_json())
    logger = MetricLogger(save_dir / "metrics.jsonl")

    model.remat = config.remat
    optimizer, sched = make_optimizer(config, model)
    state = TrainState(model, optimizer)
    device = state.device
    if resume:
        prior = ckpt_lib.best_checkpoint(save_dir)
        if prior is not None:
            ckpt_lib.restore_checkpoint(prior, state)
            print(f"resumed from {prior.name} at step {state.step}")

    k_steps = max(config.steps_per_dispatch, 1)
    host_iter = batch_iterator(train_ds, config.batch_size, shuffle=True,
                               seed=config.seed)
    if k_steps > 1:
        host_iter = stack_steps(host_iter, k_steps)
    train_iter = prefetch(to_device(host_iter, device))
    generator = torch.Generator(device=device)

    best_val = float("inf")
    t0 = time.perf_counter()
    samples_seen = 0    # samples since the timing origin (post-warm-up)
    steps_timed = 0
    warmed_up = False   # the first group is warm-up: excluded from rates
    loss = None

    def check_finite(loss_f: float):
        if not np.isfinite(loss_f):
            logger.log(state.step, {"train/loss": loss_f, "fatal": 1.0})
            raise FloatingPointError(
                f"non-finite train loss at step {state.step}: {loss_f}")

    def crossed(interval: int) -> bool:
        # a multiple of interval was reached inside this group
        return (state.step // interval) > ((state.step - k_steps) // interval)

    try:
        for batch in train_iter:
            if state.step >= config.max_steps:
                break
            if k_steps == 1:
                loss, aux = train_step(state, batch, config, sched, generator)
            else:
                for i in range(k_steps):
                    loss, aux = train_step(state, tuple(a[i] for a in batch),
                                           config, sched, generator)
            if not warmed_up:
                check_finite(float(loss))     # synchronises
                warmed_up = True
                t0 = time.perf_counter()
            else:
                samples_seen += k_steps * batch[0].shape[1 if k_steps > 1
                                                         else 0]
                steps_timed += k_steps

            if crossed(config.log_interval):
                loss_f = float(loss)
                check_finite(loss_f)
                dt = time.perf_counter() - t0
                metrics = {"train/loss": loss_f, "lr": sched(state.step),
                           **{k: float(v) for k, v in aux.items()}}
                if steps_timed:
                    metrics["samples_per_sec"] = samples_seen / max(dt, 1e-9)
                if steps_timed and flops_per_sample:
                    # forward + backward ~ 3x forward (PaLM App. B)
                    mfu = profiling.estimate_mfu(
                        3 * flops_per_sample * samples_seen / steps_timed,
                        dt / steps_timed)
                    if mfu is not None:      # None: no known peak
                        metrics["mfu"] = mfu
                logger.log(state.step, metrics)

            if crossed(config.eval_interval):
                check_finite(float(loss))     # drain the step before timing
                eval_t0 = time.perf_counter()
                val_losses = []
                for vb in to_device(batch_iterator(
                        val_ds, config.batch_size, shuffle=False, epochs=1),
                        device):
                    generator.manual_seed(_step_seed(config.seed + 1,
                                                     state.step))
                    val_losses.append(float(eval_step(state, vb, generator)))
                mean_val = (float(np.mean(val_losses)) if val_losses
                            else float("nan"))
                logger.log(state.step, {"val/loss": mean_val})
                print(f"step {state.step}: train {float(loss):.4f} val "
                      f"{mean_val:.4f}")
                select = mean_val
                if eval_metric is not None:
                    select = float(eval_metric(state, state.step))
                    logger.log(state.step, {"val/metric": select})
                if select < best_val:
                    best_val = select
                    ckpt_lib.save_checkpoint(save_dir, state, state.step,
                                             select,
                                             keep=config.keep_checkpoints)
                # eval and checkpointing are not training throughput
                t0 += time.perf_counter() - eval_t0
        if loss is not None:
            check_finite(float(loss))
    finally:
        train_iter.close()
        logger.close()
    return state
