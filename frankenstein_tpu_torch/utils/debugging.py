"""Numerics guards (``frankenstein_tpu/utils/debugging.py``): find NaN /
inf values by name, hold a compiled function to its eager self, and trap
the backward operation that makes a NaN.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _leaves(tree, path: str = ""):
    """(path, tensor or array) of every leaf of nested dicts, lists and
    tuples (a state dict is a dict), named as JAX names tree paths:
    ``enc/b/[1]``."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{path}/{key}" if path else str(key))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}/[{i}]" if path else f"[{i}]")
    elif tree is not None:
        yield path, tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf)


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming each leaf that holds NaN or inf,
    with its counts. ``tree``: a tensor, a state dict, or nested dicts,
    lists or tuples of tensors (or arrays)."""
    bad = []
    for path, leaf in _leaves(tree):
        arr = _numpy(leaf)
        if not np.isfinite(arr).all():
            bad.append(f"{path or '<root>'}: {int(np.isnan(arr).sum())} NaN, "
                       f"{int(np.isinf(arr).sum())} inf of {arr.size}")
    if bad:
        raise FloatingPointError(f"non-finite values in {name}:\n  "
                                 + "\n  ".join(bad))


def jit_eager_parity(fn: Callable, *args, backend: str = "inductor",
                     atol: float = 1e-4, rtol: float = 1e-4) -> None:
    """Assert ``torch.compile(fn, backend=backend)(*args)`` equals
    ``fn(*args)`` within the tolerances on every output leaf (the JAX
    package holds ``jax.jit(fn)`` to ``fn``)."""
    eager = dict(_leaves(fn(*args)))
    compiled = dict(_leaves(torch.compile(fn, backend=backend)(*args)))
    assert compiled.keys() == eager.keys(), (sorted(compiled), sorted(eager))
    for path, want in eager.items():
        np.testing.assert_allclose(
            _numpy(compiled[path]), _numpy(want), atol=atol, rtol=rtol,
            err_msg=f"compiled / eager divergence at {path or '<root>'}")


def enable_nan_debugging(mode: bool = True) -> None:
    """Turn on autograd's anomaly detection: a backward that produces NaN
    raises in the operation that made it, with the forward's traceback.
    ``jax_debug_nans`` (the JAX package's switch) also checks every
    forward operation; anomaly mode checks only the backward's outputs,
    so guard forward values with ``assert_finite_tree``."""
    torch.autograd.set_detect_anomaly(mode)
