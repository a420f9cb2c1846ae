"""The port's MoESwiGLU (``frankenstein_tpu_torch/models/moe.py``) against
the JAX package's on the CPU (``tests/test_moe.py``'s geometry, f32): the
same parameters, the same input, y and aux within rtol 1e-4 / atol 1e-5.
The router's weights are scaled up so its choices are decisive in both
frameworks' rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.models.moe import MoESwiGLU as JMoE
from frankenstein_tpu_torch.models.moe import MoESwiGLU, stable_topk

D, F, E = 8, 16, 4
RTOL, ATOL = 1e-4, 1e-5

torch.set_num_threads(1)


def pair(k, cap, shape, seed=0, router=10.0):
    """(jax module, jax params, port module, x) with the same weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (D,)).astype(np.float32)
    jm = JMoE(dim=D, hidden_dim=F, n_experts=E, k=k, capacity_factor=cap)
    params = jm.init(jax.random.key(seed), jnp.asarray(x))
    params = {"params": {n: np.asarray(v) * (router if n == "wg" else 1.0)
                         for n, v in params["params"].items()}}
    tm = MoESwiGLU(D, F, E, k, cap)
    with torch.no_grad():
        for n in ("wg", "w1", "w2", "w3"):
            getattr(tm, n).copy_(torch.from_numpy(params["params"][n]))
    return jm, params, tm, x


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 2])
def test_routing_matches_jax(k):
    """Top-1 (Switch) and top-2 (GShard) routing with room for every
    token."""
    jm, params, tm, x = pair(k, 50.0, (2, 6))
    y, aux = jm.apply(params, jnp.asarray(x))
    ty, taux = tm(torch.from_numpy(x))
    _close(ty, y)
    np.testing.assert_allclose(float(taux), float(aux), rtol=RTOL)


@pytest.mark.parametrize("k,cap", [(1, 0.25), (2, 0.5)])
def test_dropped_tokens_are_exactly_zero(k, cap):
    """At a capacity that drops choices the outputs match JAX's, and a
    token with every choice dropped comes out exactly zero."""
    jm, params, tm, x = pair(k, cap, (1, 16), seed=2)
    y, aux = jm.apply(params, jnp.asarray(x))
    ty, taux = tm(torch.from_numpy(x))
    _close(ty, y)
    dropped = (np.asarray(y) == 0).all(-1)
    assert dropped.any()
    assert (ty.detach().numpy()[dropped] == 0).all()
    np.testing.assert_allclose(float(taux), float(aux), rtol=RTOL)


def test_uniform_router_aux_is_one():
    """Zero router, zero input: uniform probabilities, every first choice
    on expert 0 (ties to the lower index), aux = E x 1 x 1/E = 1."""
    tm = MoESwiGLU(D, F, 2, k=1)
    y, aux = tm(torch.zeros(1, 8, D))
    assert float(aux) == pytest.approx(1.0, rel=1e-6)
    jm = JMoE(dim=D, hidden_dim=F, n_experts=2, k=1)
    jp = jax.tree_util.tree_map(lambda a: a * 0,
                                jm.init(jax.random.key(0), jnp.zeros((1, 8, D))))
    assert float(jm.apply(jp, jnp.zeros((1, 8, D)))[1]) == float(aux)


def test_gradients_match_jax_and_the_router_learns():
    jm, params, tm, x = pair(2, 2.0, (2, 8), seed=3, router=3.0)
    tgt = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jm.apply(p, xx)
        return jnp.mean((y - tgt) ** 2) + 0.01 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tm(xt)
    (torch.mean((y - torch.from_numpy(tgt)) ** 2) + 0.01 * aux).backward()
    for n in ("wg", "w1", "w2", "w3"):
        _close(getattr(tm, n).grad, jg["params"][n])
    _close(xt.grad, jgx)
    assert float(tm.wg.grad.abs().max()) > 0


def test_one_position_call_drops_nothing():
    """t == 1 (cached decode): capacity N whatever the factor."""
    jm, params, tm, x = pair(2, 0.25, (6, 1), seed=5)
    y, _ = jm.apply(params, jnp.asarray(x))
    ty, _ = tm(torch.from_numpy(x))
    _close(ty, y)
    assert tm.capacity(6, 1) == 6
    assert not (ty.detach().numpy() == 0).all(-1).any()


def test_top_k_ties_go_to_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    vals, idx = stable_topk(torch.from_numpy(probs), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_bf16_compute_keeps_the_stream_bf16():
    """An f32 LayerNorm output into a bf16-compute layer comes out bf16 (the
    JAX regression test_moe_gpt_bf16_forward); the router stays f32."""
    tm = MoESwiGLU(D, F, E, 2, dtype=torch.bfloat16)
    with torch.no_grad():
        for p in tm.parameters():
            p.normal_(0, 0.1)
    y, aux = tm(torch.randn(2, 5, D))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.isfinite(y.float()).all()


PINNED_TOL = 3e-2      # bf16 logits vs f32 with every route pinned,
                       # relative to max |f32|: a dense bf16 GPT's class
                       # (the smoke reads 1.5e-2 on the flagship's)
EXPERT_STD = 0.2       # expert weights large enough that the MoE output
                       # moves the logits and bf16 flips some routes
UNPINNED_TOL = 1e-1    # the unpinned limit's floor (chip_smoke.SLICE_TOL)
WITNESS_FACTOR = 2     # a run may reach this times bf16's own error
FAULT = 1.05           # one expert's output 5% too large


def _moe_gpt(dtype=None):
    from frankenstein_tpu_torch.config import GPTConfig
    from frankenstein_tpu_torch.models.gpt2 import GPT, init_gpt_
    gpt = GPT(GPTConfig(block_size=32, vocab_size=96, n_layer=2, n_head=2,
                        n_embd=32, moe_experts=4, moe_k=2), dtype=dtype)
    init_gpt_(gpt, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for block in gpt.transformer["h"]:
            for w in (block.moe.w1, block.moe.w2, block.moe.w3):
                w.normal_(0.0, EXPERT_STD, generator=gen)
    return gpt


def _routes(model, run):
    """(run()'s result, each MoE layer call's top-k experts [N, K])."""
    routes = []

    def grab(mod, args):
        x = args[0].reshape(-1, mod.dim).to(mod.compute_dtype
                                            or mod.w1.dtype)
        probs = (x.float() @ mod.wg.float()).softmax(-1)
        routes.append(stable_topk(probs, mod.k)[1])

    hooks = [m.register_forward_pre_hook(grab) for m in model.modules()
             if isinstance(m, MoESwiGLU)]
    try:
        return run(), routes
    finally:
        for h in hooks:
            h.remove()


def _pinned(monkeypatch, routes):
    """Every MoE call takes the next recorded expert choice (its gates
    the probabilities of those experts), as the smoke's pinned check
    does."""
    from frankenstein_tpu_torch.models import moe
    todo = list(routes)

    def take(probs, k):
        idx = todo.pop(0).to(probs.device)
        return probs.gather(-1, idx), idx

    monkeypatch.setattr(moe, "stable_topk", take)
    return todo


def test_pinned_routes_hold_bf16_logits_to_the_dense_class(monkeypatch):
    """The MoE GPT in bf16 compute against its f32 twin. Unpinned, bf16
    flips near-tied routes, so the logits are held only to the larger of
    0.1 and twice bf16's own error; with every route pinned to the twin's
    choice the bf16 logits are held to a dense bf16 GPT's class. A fault
    of 5% in one expert's output passes the unpinned limit and fails the
    pinned one (twice the correct pinned error), as in the smoke's phase
    23 (c)."""
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 96, (2, 24)))
    twin = _moe_gpt()
    with torch.no_grad():
        want, routes = _routes(twin, lambda: twin(idx, targets=idx)[1])

    def err(model, pinned: bool):
        with monkeypatch.context() as m, torch.no_grad():
            left = _pinned(m, routes) if pinned else None
            got = model(idx, targets=idx)[1]
            assert not left
        return float((got - want).abs().max() / want.abs().max())

    bf16 = _moe_gpt(torch.bfloat16)
    bf16.load_state_dict(twin.state_dict())
    faulty = _moe_gpt(torch.bfloat16)
    faulty.load_state_dict(twin.state_dict())
    with torch.no_grad():
        for block in faulty.transformer["h"]:
            block.moe.w2[0] *= FAULT
    with torch.no_grad():
        flipped = _routes(bf16, lambda: bf16(idx, targets=idx))[1]
    assert any(not torch.equal(a.sort(-1).values, b.sort(-1).values)
               for a, b in zip(flipped, routes)), "bf16 flipped no route"
    unpinned, pinned = err(bf16, False), err(bf16, True)
    assert pinned <= PINNED_TOL and pinned < unpinned, (pinned, unpinned)
    fault_unpinned, fault_pinned = err(faulty, False), err(faulty, True)
    assert fault_unpinned <= max(UNPINNED_TOL, WITNESS_FACTOR * unpinned)
    assert fault_pinned > WITNESS_FACTOR * pinned, (fault_pinned, pinned)
