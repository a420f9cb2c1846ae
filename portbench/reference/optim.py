"""Plain AdamW with a value clip and the warm-up, cosine schedule: the
training configuration's update, written from its definition."""

from __future__ import annotations

import math

import torch


def lr_at(train: dict, update: int) -> float:
    """The learning rate of update ``update`` (0 for the first): linear
    warm-up over ``warmup_iters``, cosine decay to a tenth by
    ``lr_decay_iters``, then that tenth."""
    lr, warm = train["learning_rate"], train.get("warmup_iters", 2000)
    decay, floor = train.get("lr_decay_iters", 50000), lr / 10
    if not train.get("use_scheduler", True):
        return lr
    if update < warm:
        return lr * update / max(warm, 1)
    if update > decay:
        return floor
    ratio = min(max((update - warm) / max(decay - warm, 1), 0.0), 1.0)
    return floor + 0.5 * (1.0 + math.cos(math.pi * ratio)) * (lr - floor)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, train: dict,
                 update: int) -> None:
    """One update in place: clip each gradient to [-grad_clip, grad_clip],
    decay each parameter by lr * weight_decay, then Adam's bias-corrected
    step (b1, b2 from ``adam_b1``, ``adam_b2``; eps 1e-8). ``state`` holds
    each parameter's (m, v)."""
    lr = lr_at(train, update)
    b1, b2 = train.get("adam_b1", 0.9), train.get("adam_b2", 0.999)
    wd, clip = train.get("weight_decay", 0.0), train.get("grad_clip", 1.0)
    t = update + 1
    for name, p in params.items():
        g = grads[name].clamp(-clip, clip)
        m, v = state.setdefault(name, (torch.zeros_like(p),
                                       torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.mul_(1 - lr * wd)
        denom = (v / (1 - b2 ** t)).sqrt_().add_(1e-8)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))
