"""K9's Hopper design (``csrc/fused_mlp.cu``) from the CPU.

- A float64 mirror of the kernel's chunked product order: h as the norm
  gives it in bf16, then hidden chunks of NC columns, each chunk's a and b
  rounded to bf16 where the kernel rounds them, g = bf16(bf16(silu(a)) *
  b), y summed chunk by chunk, out = bf16(x + bf16(y)), matches the plain
  twin (``fused_norm_swiglu_ref``) and the JAX package's kernel in Pallas
  interpret mode within K9_TOL of max |twin| (the card's tolerance: the
  three round a, b and g after sums taken in other orders), for both norms,
  E in {64, 256} and hidden in {512, 1024}.
- The shape sweep's production candidate is the source's ``MlpOf`` line,
  and the source's chunk width divides the gate's hidden.

Inputs from numpy seeds."""

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from frankenstein_tpu.ops.pallas import fused_mlp as jfused
from frankenstein_tpu_torch.ops.cuda import fused_mlp as k9
from frankenstein_tpu_torch.tools import k9_shape_sweep

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "frankenstein_tpu_torch" / "csrc" / "fused_mlp.cu"
K9_TOL = 2e-2   # relative to max |twin| (chip_smoke.py's)
NC = 32         # hidden columns a chunk (MlpOf)


def _bf16(a):
    return np.asarray(a, np.float64).astype(ml_dtypes.bfloat16).astype(
        np.float64)


def _params(seed, e, hidden, kind):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    return dict(
        x=_bf16(rng.standard_normal((2, 128, e))).astype(np.float32),
        nw=f32(1.0 + 0.1 * rng.standard_normal(e)),
        nb=f32(0.1 * rng.standard_normal(e)) if kind == "layernorm" else None,
        w1=_bf16(rng.standard_normal((hidden, e)) / np.sqrt(e)),
        w3=_bf16(rng.standard_normal((hidden, e)) / np.sqrt(e)),
        w2=_bf16(rng.standard_normal((e, hidden)) / np.sqrt(hidden)))


def _chunked_mirror(h, x, w1, w3, w2, nc):
    """The kernel's products in float64 over [R, E] bf16 h and x and
    nn.Linear-layout weights: per hidden chunk of nc columns, a and b
    rounded to bf16, the gate rounded where the kernel rounds, y summed
    chunk by chunk; out = bf16(x + bf16(y))."""
    y = np.zeros_like(x)
    for c0 in range(0, w1.shape[0], nc):
        a = _bf16(h @ w1[c0:c0 + nc].T)
        b = _bf16(h @ w3[c0:c0 + nc].T)
        s = _bf16(a / (1.0 + np.exp(-a)))
        g = _bf16(s * b)
        y += g @ w2[:, c0:c0 + nc].T
    return _bf16(x + _bf16(y))


@pytest.mark.parametrize("hidden", [512, 1024])
@pytest.mark.parametrize("e", [64, 256])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_chunked_mirror_matches_twin_and_jax_kernel(kind, e, hidden):
    p = _params(e + hidden, e, hidden, kind)
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    x = t(p["x"]).to(torch.bfloat16)
    w1, w3, w2 = (t(p[k]).to(torch.bfloat16) for k in ("w1", "w3", "w2"))
    twin = k9.fused_norm_swiglu_ref(x, t(p["nw"]), t(p["nb"]), w1, w3, w2,
                                    kind=kind).float().numpy()
    h = k9.norm_fn(x, t(p["nw"]), t(p["nb"]), kind).to(torch.bfloat16)
    rows = lambda a: np.asarray(a, np.float64).reshape(-1, e)
    got = _chunked_mirror(rows(h.float().numpy()), rows(p["x"]), p["w1"],
                          p["w3"], p["w2"], NC).reshape(twin.shape)
    top = np.abs(twin).max()
    assert np.abs(got - twin).max() <= K9_TOL * top
    # the JAX kernel takes flax-layout ([in, out]) weights
    jx = jnp.asarray(p["x"]).astype(jnp.bfloat16)
    jw = [None if p[k] is None else jnp.asarray(p[k]) for k in ("nw", "nb")]
    jw += [jnp.asarray(p[k].T).astype(jnp.bfloat16)
           for k in ("w1", "w3", "w2")]
    want = np.asarray(jfused.fused_norm_swiglu(jx, *jw, kind=kind,
                                               interpret=True), np.float64)
    assert np.abs(got - want).max() <= K9_TOL * top


def test_sweep_production_shape_is_the_sources():
    text = SOURCE.read_text()
    found = [" ".join(rhs.split())
             for rhs in re.findall(r"using MlpOf = ([^;]*);", text)]
    assert found == [k9_shape_sweep.CANDIDATES["production"]]
    assert list(k9_shape_sweep.CANDIDATES)[0] == "production"
    assert re.fullmatch(r"MlpPass<E, NWG, (\d+), .*>", found[0]).group(1) == \
        str(NC)
    assert k9_shape_sweep.MLP_OF.search(text)
    # the gate's hidden (a multiple of 64) is whole chunks of every
    # candidate's width
    for rhs in k9_shape_sweep.CANDIDATES.values():
        nc = int(re.fullmatch(r"MlpPass<E, \w+, (\d+), .*>", rhs).group(1))
        assert 64 % nc == 0 or nc == 64, rhs
