"""LR schedule: linear warmup -> cosine decay -> floor at lr/10
(``frankenstein_tpu/train/schedule.py``).

The trainer evaluates it at the index of the update about to be made (0 for
the first), as optax counts updates, so with warmup > 0 the first update
uses lr 0.
"""

from __future__ import annotations

import math

from frankenstein_tpu_torch.config import TrainConfig


def make_lr_schedule(config: TrainConfig):
    lr = config.learning_rate
    warm = config.warmup_iters
    decay = config.lr_decay_iters
    min_lr = lr / 10

    def get_lr(step) -> float:
        step = float(step)
        if not config.use_scheduler:
            return lr
        if step < warm:
            return lr * step / max(warm, 1)
        if step > decay:
            return min_lr
        ratio = min(max((step - warm) / max(decay - warm, 1), 0.0), 1.0)
        coeff = 0.5 * (1.0 + math.cos(math.pi * ratio))
        return min_lr + coeff * (lr - min_lr)

    return get_lr
