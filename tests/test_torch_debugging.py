"""The port's ``utils/debugging.py`` beside the JAX package's on the CPU:
``assert_finite_tree`` names each bad leaf of nested containers and state
dicts as the JAX guard names its paths, ``jit_eager_parity`` holds
``torch.compile`` to eager and catches a divergence, and
``enable_nan_debugging`` turns autograd's anomaly mode on and off."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.utils import debugging as jdebugging
from frankenstein_tpu_torch.utils import debugging


def _tree(bad: bool):
    leaf = torch.tensor([1.0, float("nan"), float("inf")]) if bad \
        else torch.ones(3)
    return {"enc": {"w": torch.zeros(2, 2), "b": [torch.ones(1), leaf]},
            "step": torch.tensor(3)}


def test_finite_tree_passes():
    debugging.assert_finite_tree(_tree(False))
    debugging.assert_finite_tree(torch.nn.Linear(3, 2).state_dict())
    debugging.assert_finite_tree([np.ones(2), (torch.zeros(1), None)])


def test_bad_leaves_are_named_as_jax_names_them():
    with pytest.raises(FloatingPointError) as got:
        debugging.assert_finite_tree(_tree(True), name="params")
    jtree = {"enc": {"w": jnp.zeros((2, 2)),
                     "b": [jnp.ones(1), jnp.array([1.0, np.nan, np.inf])]},
             "step": jnp.array(3)}
    with pytest.raises(FloatingPointError) as want:
        jdebugging.assert_finite_tree(jtree, name="params")
    assert "enc/b/[1]: 1 NaN, 1 inf of 3" in str(got.value)
    assert str(got.value) == str(want.value)


def test_state_dict_entries_are_named():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.ReLU(),
                                torch.nn.Linear(2, 1))
    with torch.no_grad():
        model[2].bias.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match=r"2\.bias: 1 NaN, 0 inf"):
        debugging.assert_finite_tree(model.state_dict(), name="model")


def test_bf16_leaves_are_checked():
    with pytest.raises(FloatingPointError, match="x: 0 NaN, 1 inf of 2"):
        debugging.assert_finite_tree(
            {"x": torch.tensor([1.0, float("inf")], dtype=torch.bfloat16)})


def test_compiled_matches_eager():
    def fn(x, w):
        h = torch.tanh(x @ w)
        return {"h": h, "parts": (h.sum(), h * 2)}

    x, w = torch.randn(4, 3), torch.randn(3, 5)
    debugging.jit_eager_parity(fn, x, w, backend="aot_eager")
    assert inspect.signature(debugging.jit_eager_parity).parameters[
        "backend"].default == "inductor"


def test_a_divergence_is_caught(monkeypatch):
    monkeypatch.setattr(torch, "compile",
                        lambda fn, backend: lambda *a: {"y": fn(*a)["y"] + 1})
    with pytest.raises(AssertionError, match="divergence at y"):
        debugging.jit_eager_parity(lambda x: {"y": x * 2}, torch.ones(3))


def test_nan_debugging_traps_the_backward():
    try:
        debugging.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        debugging.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
