"""The benchmark's weights: drawn from the seed on the device, in one call,
and handed alike to the program and to the reference.

``make`` takes the program's parameter names and shapes (what the weights
are for) and a rule giving each parameter's (mean, std) (the reference's
``init_rule``), so the values are the benchmark's and not the program's
initialisers'. The same seed on the same device gives the same values, so a
run draws them again for its reference instead of keeping a copy.
"""

from __future__ import annotations

import math

import torch


def make(shapes, rule, seed: int, device, dtype=torch.float32,
         n_layer: int = 0) -> dict:
    """{name: tensor of ``dtype``} for ``shapes`` = [(name, shape)], each
    ``mean + std * N(0, 1)`` with (mean, std) = ``rule(name, shape,
    n_layer)``, from one draw of a generator on ``device`` seeded with
    ``seed``."""
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        mean, std = rule(name, shape, n_layer)
        out[name] = (flat[at:at + n].view(shape) * std + mean).to(dtype)
        at += n
    return out


@torch.no_grad()
def load(model, params: dict) -> None:
    """Copy ``params`` into the model's parameters of the same names
    (every parameter must be given; a tied weight once)."""
    named = dict(model.named_parameters())
    missing = set(named) - set(params)
    if missing:
        raise KeyError(f"no benchmark weights for {sorted(missing)[:5]}")
    for name, p in named.items():
        p.copy_(params[name])
