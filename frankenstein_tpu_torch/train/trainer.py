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
- with ``flops_per_sample`` (forward FLOPs over the attention pairs the
  masks leave visible, ``utils/profiling.py``) and a card whose peak is
  known, each log line has ``mfu``: 3 x forward FLOPs a step over the step
  time and the peak, the rule the benchmark's ``mfu.train`` and
  ``mfu.finetune`` use (the JAX package counts every attention pair);
- under a profiler a step is a ``train.step`` span holding
  ``train.prepare``, a ``train.forward`` and a ``train.backward`` per
  microbatch, and ``train.update`` (``utils/profiling.py:span``).

Over a process group (torchrun, or a test's own group), ``mesh_shape``
(data, model) and ``fsdp`` take the JAX trainer's parallel layouts
(``setup_parallel``): every rank reads the same global batch and keeps its
rows of the data dimension (``parallel/mesh.py:shard_batch``, each
microbatch split over the group as the JAX global microbatch is); the
forward runs under ``mesh.batch_shard``, so the loss, the MoE routing,
SoundStream's codebook statistics and the random draws are the global
batch's, and the gradients are averaged
over the data group by DDP, or reduce-scattered by FSDP2 (``fully_shard``
over the data dimension, each parameter on ``sharding.fsdp_spec``'s
dimension). The model dimension shards the experts of an MoE model
(``models/moe.py:shard_experts``) and is a replica axis otherwise, as the
JAX trainer's is. Checkpoints hold full state dicts, written by rank 0
(``sharding.full_state``), so serving and resume read them as they read a
one-device run's. Without a process group a run is one device, and a
``mesh_shape`` of more than one device raises.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from frankenstein_tpu_torch.config import TrainConfig
from frankenstein_tpu_torch.parallel import mesh as mesh_lib
from frankenstein_tpu_torch.parallel import sharding as shard_lib
from frankenstein_tpu_torch.train.schedule import make_lr_schedule
from frankenstein_tpu_torch.utils import profiling
from frankenstein_tpu_torch.utils.metrics import MetricLogger


@dataclasses.dataclass
class Parallel:
    """A run's layout over a process group: the (data, model) mesh, its
    data group, and the module the forward calls (DDP, or the model itself
    under FSDP2, whose hooks are on it)."""
    mesh: object
    data_group: object
    runner: nn.Module
    fsdp: bool = False


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0          # optimizer updates made so far
    parallel: Optional[Parallel] = None

    @property
    def device(self) -> torch.device:
        p = next(self.model.parameters())
        return getattr(p, "to_local", lambda: p)().device

    @property
    def runner(self) -> nn.Module:
        return self.model if self.parallel is None else self.parallel.runner

    @property
    def data_group(self):
        return None if self.parallel is None else self.parallel.data_group


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


def _loss(state: TrainState, batch, *, train: bool, generator=None):
    """(the model's loss on ``batch`` = (x, targets[, date_info]), the
    ``aux`` scalars its forward left, or {})."""
    model = state.model
    targets = batch[1] if getattr(model, "needs_labels", True) else None
    date_info = batch[2] if len(batch) > 2 else None
    loss, _ = state.runner(batch[0], targets, train=train,
                           generator=generator, date_info=date_info)
    return loss, dict(getattr(model, "aux", {}))


def _group_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of a detached scalar over ``group``."""
    if mesh_lib.group_size(group) == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t / mesh_lib.group_size(group)


def loss_and_grads(state: TrainState, batch, config: TrainConfig,
                   generator: Optional[torch.Generator] = None,
                   aux: Optional[dict] = None):
    """Mean loss over ``grad_accum`` equal microbatches of ``batch``, with
    the mean gradients left in the parameters' ``.grad`` and, when ``aux``
    is given, the model's mean aux scalars written into it. Applies the
    step's augmentation and bf16 input cast first. The microbatches run in
    order, each on the buffers the last one wrote. Over a data group
    ``batch`` is the global batch: it is augmented whole, each rank keeps
    its rows, and the loss returned is the global one."""
    accum = max(config.grad_accum, 1)
    group = state.data_group
    with profiling.span("train.prepare"):
        if config.p_augs > 0.0:
            batch = augment_batch(batch, generator, config.p_augs)
        if config.mixed_precision:
            batch = tuple(a.to(torch.bfloat16) if a.is_floating_point()
                          else a for a in batch)
        batch = mesh_lib.shard_batch(batch, group, accum)
        state.optimizer.zero_grad(set_to_none=True)
    n = batch[0].shape[0] // accum
    total, aux_sum = None, {}
    with mesh_lib.batch_shard(group):
        for i in range(accum):
            micro = tuple(a[i * n:(i + 1) * n] for a in batch)
            with profiling.span("train.forward"):
                loss, micro_aux = _loss(state, micro, train=True,
                                        generator=generator)
            with profiling.span("train.backward"):
                (loss / accum).backward()
            total = loss.detach() if total is None else total + loss.detach()
            for key, value in micro_aux.items():
                aux_sum[key] = aux_sum.get(key, 0.0) + value.detach()
    if aux is not None:
        aux.update({k: _group_mean(v / accum, group)
                    for k, v in aux_sum.items()})
    return _group_mean(total / accum, group)


def apply_update(state: TrainState, config: TrainConfig, sched) -> None:
    """The update from the gradients in ``.grad``: clip by value, set the lr
    from the schedule at this update's index, AdamW, count the step."""
    if state.parallel is not None and state.parallel.fsdp:
        for p in state.model.parameters():      # DTensor gradients
            if p.grad is not None:
                p.grad.clamp_(-config.grad_clip, config.grad_clip)
    else:
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
    with profiling.span("train.step"):
        generator.manual_seed(_step_seed(config.seed, state.step))
        aux = {}
        loss = loss_and_grads(state, batch, config, generator, aux)
        with profiling.span("train.update"):
            if state.parallel is None:
                grads = [p.grad for p in state.model.parameters()
                         if p.grad is not None]
                gnorm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g) for g in grads]))
            else:
                gnorm = shard_lib.grad_norm(state.model,
                                            state.parallel.mesh)
            apply_update(state, config, sched)
    return loss, {"grad_norm": gnorm, **aux}


@torch.no_grad()
def eval_step(state: TrainState, batch,
              generator: Optional[torch.Generator] = None):
    """The loss of one (global) eval batch; ``generator`` draws what the
    model draws in eval (the MAE's mask), Franky ignores it."""
    group = state.data_group
    with mesh_lib.batch_shard(group):
        loss = _loss(state, mesh_lib.shard_batch(batch, group), train=False,
                     generator=generator)[0]
    return _group_mean(loss, group)


def setup_parallel(model: nn.Module, config: TrainConfig,
                   device: torch.device) -> Optional[Parallel]:
    """The run's layout over the current process group (None without
    one): the (data, model) mesh of ``config.mesh_shape`` (all ranks on
    "data" when None), the experts of an MoE model sharded over "model",
    every other parameter broadcast from rank 0, then FSDP2 over "data"
    (``config.fsdp``) or DDP over "data". A shape whose size is not the
    world size raises ``ValueError``; without a process group so does any
    shape of more than one device."""
    from frankenstein_tpu_torch.models.moe import shard_experts

    mesh = mesh_lib.make_mesh(config.mesh_shape, device.type)
    if mesh is None:
        if config.fsdp:
            raise ValueError("fsdp needs a process group (torchrun)")
        return None
    data = mesh_lib.group_of(mesh, mesh_lib.DATA_AXIS)
    model_group = mesh_lib.group_of(mesh, mesh_lib.MODEL_AXIS)
    shard_experts(model, model_group)
    mesh_lib.replicate([p for p in model.parameters()
                        if not hasattr(p, "shard_spec")])
    mesh_lib.replicate([p for p in model.parameters()
                        if hasattr(p, "shard_spec")], data)
    mesh_lib.replicate(model.buffers())
    if config.fsdp:
        shard_lib.shard_params_fsdp(model, mesh)
        return Parallel(mesh, data, model, fsdp=True)
    from torch.nn.parallel import DistributedDataParallel
    ids = None
    if device.type == "cuda":
        ids = [torch.cuda.current_device() if device.index is None
               else device.index]
    runner = DistributedDataParallel(model, process_group=data,
                                     device_ids=ids)
    return Parallel(mesh, data, runner)


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

    train_ds, val_ds = datasets
    save_dir = Path(save_folder) / config.exp_name
    main = not dist.is_initialized() or dist.get_rank() == 0
    if main:
        save_dir.mkdir(parents=True, exist_ok=True)
        (save_dir / "train_config.json").write_text(config.to_json())
    logger = MetricLogger(save_dir / "metrics.jsonl" if main else None)

    model.remat = config.remat
    device = next(model.parameters()).device
    prior = ckpt_lib.best_checkpoint(save_dir) if resume else None
    raw = ckpt_lib.load_raw_checkpoint(prior) if prior is not None else None
    if raw is not None:        # full weights, before any sharding
        model.load_state_dict(raw["model"])
    par = setup_parallel(model, config, device)
    optimizer, sched = make_optimizer(config, model)
    state = TrainState(model, optimizer, parallel=par)
    if raw is not None:
        optimizer.load_state_dict(shard_lib.local_optimizer_state(
            raw["optimizer"], optimizer))
        state.step = int(raw["step"])
        if main:
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
                    # forward + backward ~ 3x forward (PaLM App. B), a
                    # card's share of the global batch
                    world = dist.get_world_size() if par else 1
                    mfu = profiling.estimate_mfu(
                        3 * flops_per_sample * samples_seen
                        / (steps_timed * world), dt / steps_timed)
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
                if main:
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
                                             keep=config.keep_checkpoints,
                                             payload=shard_lib.full_state(
                                                 model, optimizer)
                                             if par else None,
                                             write=main)
                # eval and checkpointing are not training throughput
                t0 += time.perf_counter() - eval_t0
        if loss is not None:
            check_finite(float(loss))
    finally:
        train_iter.close()
        logger.close()
    return state
