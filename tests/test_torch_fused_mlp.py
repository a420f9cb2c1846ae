"""Kernel K9's plain twin and autograd Function (``ops/cuda/fused_mlp.py``)
and the port's ``Block`` against the JAX package's ``fused_norm_swiglu``
(Pallas interpret mode) and ``Block`` with its fused path forced on, at the
shapes of ``tests/test_fused_mlp.py`` (B=2, T=256, E=128, hidden 256);
inputs from numpy seeds. Tolerances are that file's: 1e-5 in f32, 2e-2 in
bf16, 1e-4 on gradients. Also the K9 gate, gradients under remat, and a
tiny bf16 encoder through the K9 route against the JAX encoder's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.config import MAEConfig as JMAEConfig
from frankenstein_tpu.models import brainformer as jbrain
from frankenstein_tpu.models.import_reference import (_export_block,
                                                      export_encoder)
from frankenstein_tpu.models.layers import Block as JBlock
from frankenstein_tpu.ops.pallas import fused_mlp as jfused
from frankenstein_tpu_torch.config import MAEConfig
from frankenstein_tpu_torch.models.brainformer import Encoder
from frankenstein_tpu_torch.models.layers import (Block, SwiGLU, make_norm,
                                                  run_block)
from frankenstein_tpu_torch.models.weights import load_strict
from frankenstein_tpu_torch.ops.cuda import fused_mlp as k9

torch.set_num_threads(1)

B, T, E, H = 2, 256, 128, 256
KINDS = ["layernorm", "rmsnorm"]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _params(seed, kind):
    """numpy norm parameters and flax-layout ([in, out]) kernels; no bias
    for RMSNorm."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    return dict(
        nw=f32(1.0 + 0.1 * rng.standard_normal(E)),
        nb=f32(0.1 * rng.standard_normal(E)) if kind == "layernorm" else None,
        w1=f32(rng.standard_normal((E, H)) / np.sqrt(E)),
        w3=f32(rng.standard_normal((E, H)) / np.sqrt(E)),
        w2=f32(rng.standard_normal((H, E)) / np.sqrt(H)))


def _jax_args(p):
    return [None if p[k] is None else jnp.asarray(p[k])
            for k in ("nw", "nb", "w1", "w3", "w2")]


def _torch_args(p, requires_grad=False):
    """nw, nb and nn.Linear-layout ([out, in]) weights as tensors."""
    out = []
    for k in ("nw", "nb", "w1", "w3", "w2"):
        if p[k] is None:
            out.append(None)
            continue
        a = p[k].T if k.startswith("w") else p[k]
        out.append(torch.from_numpy(np.ascontiguousarray(a))
                   .requires_grad_(requires_grad))
    return out


def _x(seed, shape=(B, T, E)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_twin_matches_jax_kernel_interpret(kind, dtype):
    p, x = _params(0, kind), _x(1)
    want = jfused.fused_norm_swiglu(jnp.asarray(x).astype(JDTYPE[dtype]),
                                    *_jax_args(p), kind=kind, interpret=True)
    before = k9.launches
    got = k9.fused_norm_swiglu(torch.from_numpy(x).to(dtype), *_torch_args(p),
                               kind=kind)
    assert k9.launches == before               # CPU: the twin, no kernel
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("kind", KINDS)
def test_function_grads_match_jax_grad_interpret(kind):
    """``FusedNormSwiGLU`` against ``jax.grad`` through the JAX kernel (its
    custom VJP) in interpret mode: d/dx, the norm's parameters and the
    three weights of sum(sin(out))."""
    p, x = _params(2, kind), _x(3)
    names = [k for k in ("nw", "nb", "w1", "w3", "w2") if p[k] is not None]

    def loss(x, *ws):
        full = dict(zip(names, ws))
        args = [full.get(k) for k in ("nw", "nb", "w1", "w3", "w2")]
        return jnp.sum(jnp.sin(jfused.fused_norm_swiglu(
            x, *args, kind=kind, interpret=True)))

    want = jax.grad(loss, argnums=tuple(range(len(names) + 1)))(
        jnp.asarray(x), *(jnp.asarray(p[k]) for k in names))
    tx = torch.from_numpy(x).requires_grad_()
    targs = _torch_args(p, requires_grad=True)
    out = k9.FusedNormSwiGLU.apply(tx, *targs, kind)
    torch.sin(out).sum().backward()
    got = [tx.grad] + [a.grad.T if k.startswith("w") else a.grad
                       for k, a in zip(("nw", "nb", "w1", "w3", "w2"), targs)
                       if a is not None]
    for name, g, w in zip(["x", *names], got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def _modules(kind, dtype, seed):
    """The port's norm and SwiGLU modules (f32 parameters, compute dtype
    ``dtype``) holding ``_params(seed)``."""
    p = _params(seed, kind)
    norm, mlp = make_norm(kind, E), SwiGLU(E, H, dtype=dtype)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(p["nw"]))
        if p["nb"] is not None:
            norm.bias.copy_(torch.from_numpy(p["nb"]))
        for k in ("w1", "w3", "w2"):
            getattr(mlp, k).weight.copy_(torch.from_numpy(p[k].T))
    return norm, mlp


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_grads_equal_module_chain_bitwise(kind, dtype):
    """For one fixed upstream gradient, the Function's gradients are those
    of the port's module chain x + SwiGLU(norm(x)), bit for bit: its
    backward is that chain's autograd, recomputed."""
    norm, mlp = _modules(kind, dtype, 4)
    x = torch.from_numpy(_x(5)).to(dtype).requires_grad_()
    dy = torch.from_numpy(_x(6)).to(dtype)
    leaves = [x, *norm.parameters(), *mlp.parameters()]
    out = k9.FusedNormSwiGLU.apply(
        x, norm.weight, getattr(norm, "bias", None), mlp.w1.weight,
        mlp.w3.weight, mlp.w2.weight, kind)
    got = torch.autograd.grad(out, leaves, dy)
    want = torch.autograd.grad(x + mlp(norm(x)), leaves, dy)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.fixture
def twin_calls(monkeypatch):
    """The number of times K9's twin ran (the K9 route on the CPU)."""
    calls = [0]
    real = k9.fused_norm_swiglu_ref

    def spy(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    monkeypatch.setattr(k9, "fused_norm_swiglu_ref", spy)
    return calls


def test_remat_gradients_equal_plain(twin_calls):
    """A Block under ``run_block(remat=True)`` (non-reentrant checkpoint)
    recomputes its forward, the K9 route included, and its gradients equal
    those without remat."""
    torch.manual_seed(0)
    block = Block(E, 4, 32, H)
    x = torch.from_numpy(_x(7)).requires_grad_()
    dy = torch.from_numpy(_x(8))
    leaves = [x, *block.parameters()]
    grads, calls = [], []
    for remat in (False, True):
        twin_calls[0] = 0
        grads.append(torch.autograd.grad(run_block(block, x, remat=remat),
                                         leaves, dy))
        calls.append(twin_calls[0])
    assert calls == [1, 2]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("norm", KINDS)
def test_block_matches_jax_block_fused(monkeypatch, twin_calls, norm):
    """The port's Block (its MLP through the K9 route, the twin on the CPU)
    against the JAX Block with ``fused_mlp.ENABLED`` and
    ``FORCE_INTERPRET`` on (its Pallas kernel in interpret mode), weights
    carried across as numpy by the JAX package's block exporter."""
    monkeypatch.setattr(jfused, "ENABLED", True)
    monkeypatch.setattr(jfused, "FORCE_INTERPRET", True)
    jblock = JBlock(dim=E, n_heads=4, head_dim=32, hidden_dim=H, norm=norm)
    x = _x(9)
    params = jblock.init(jax.random.PRNGKey(10), jnp.asarray(x))
    rng = np.random.default_rng(11)       # norms away from their unit init
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    assert jfused.supported(B, T, E, H, 4)
    want = jblock.apply(params, jnp.asarray(x))
    state = {}
    _export_block(state, "", jax.tree_util.tree_map(np.asarray,
                                                    params["params"]))
    block = load_strict(Block(E, 4, 32, H, norm=norm), state)
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    assert twin_calls[0] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_supported_rejects_what_the_kernel_does_not_take():
    """The gate: x in another dtype than the compute dtype (the MAE
    decoder's f32 stream under bf16 compute) on any device, and on the card
    f32, E or hidden not a multiple of 64, E > 256; the flagship encoder's
    and the Perceiver's MLPs pass, and the CPU twin takes tiny widths."""
    bf16, f32 = torch.bfloat16, torch.float32
    for device in ("cuda", "cpu"):
        assert not k9.supported(device, f32, 256, 1024, bf16)
    for e, hidden in ((96, 1024), (256, 1000), (320, 1024), (256, 0)):
        assert not k9.supported("cuda", bf16, e, hidden, bf16)
    assert not k9.supported("cuda", f32, 256, 1024, f32)
    assert k9.supported("cuda", bf16, 256, 1024, bf16)
    assert k9.supported("cuda", bf16, 256, 512, bf16)
    assert k9.supported("cpu", f32, 16, 32, f32)


def test_block_takes_the_gate(monkeypatch, twin_calls):
    """Block routes to K9 only when ``ENABLED`` and ``supported`` hold; the
    module chain gives the same output in f32."""
    torch.manual_seed(1)
    block = Block(E, 4, 32, H)
    x = torch.from_numpy(_x(12))
    with torch.no_grad():
        fused = block(x)
        monkeypatch.setattr(k9, "ENABLED", False)
        chain = block(x)
        monkeypatch.setattr(k9, "ENABLED", True)
        monkeypatch.setattr(k9, "supported", lambda *a: False)
        gated = block(x)
    assert twin_calls[0] == 1
    torch.testing.assert_close(fused, chain, atol=1e-5, rtol=1e-5)
    assert torch.equal(chain, gated)


def test_bf16_encoder_matches_jax_encoder_fused(monkeypatch, twin_calls):
    """A tiny bf16 encoder whose T, E and hidden the JAX gate takes (512
    tokens, width 128, hidden 256): the port through the K9 route (and K1's
    twin) against the JAX encoder with its fused MLP forced on in
    interpret mode, within 2e-2."""
    monkeypatch.setattr(jfused, "ENABLED", True)
    monkeypatch.setattr(jfused, "FORCE_INTERPRET", True)
    geom = dict(window_size=64, n_electrodes=64, patch_size=8, dim=E,
                n_layers=2, head_dim=32, hidden_dim=H, n_heads=4,
                n_kv_heads=4)
    jcfg = JMAEConfig(**geom)
    jenc = jbrain.Encoder(jcfg, dtype=jnp.bfloat16)
    x = _x(13, (1, 64, 64))
    params = jenc.init(jax.random.PRNGKey(14), jnp.asarray(x))
    assert jfused.supported(1, jcfg.block_size, E, H, 2)
    want = jenc.apply(params, jnp.asarray(x))
    enc = load_strict(Encoder(MAEConfig(**geom), dtype=torch.bfloat16),
                      export_encoder(params))
    with torch.no_grad():
        got = enc(torch.from_numpy(x).to(torch.bfloat16))
    assert twin_calls[0] == geom["n_layers"]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)
