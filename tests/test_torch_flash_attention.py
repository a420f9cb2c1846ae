"""Kernels K6 and K7's plain twins (``ops/cuda/flash_attention.py``) against
the JAX package's Pallas kernels they replace, in interpret mode:
``gathered_slab_attention`` (K6), ``dense_flash_attention`` and
``slab_causal_attention`` (K7), forward, lse and ``jax.grad``; the autograd
Function around them against autograd through plain attention; the routing
of ``ops/attention.py:dot_product_attention``, its gate and the plain
routes it takes when the gate shuts. float32 (float64
for gradcheck); inputs from numpy seeds. Tolerances are those of
``tests/test_attention.py``: 3e-5 forward, 1e-4 gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.ops import attention as jattn
from frankenstein_tpu.ops import masks as jmasks
from frankenstein_tpu.ops.pallas import block_attention
from frankenstein_tpu_torch.ops import attention as tattn
from frankenstein_tpu_torch.ops import masks as tmasks
from frankenstein_tpu_torch.ops.cuda import flash_attention as flash

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 3e-5, 1e-4


def _qkv(seed, b, t, h, d, n=3, scale=1.0):
    """[B, T, H, D] float32 arrays (the JAX package's layout)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, t, h, d)) * scale).astype(np.float32)
            for _ in range(n)]


def _sorted_subset(seed, b, n_full, n_keep):
    rng = np.random.default_rng(seed)
    return np.stack([np.sort(rng.choice(n_full, size=n_keep, replace=False))
                     for _ in range(b)]).astype(np.int32)


def _fold(x):
    b, t, h, d = x.shape
    return torch.from_numpy(np.ascontiguousarray(x)).reshape(b, t, h * d)


def _unfold(x, h):
    b, t, e = x.shape
    return x.reshape(b, t, h, e // h).detach().numpy()


def _twin(mode, q, k, v, h, p=0, pos=None):
    sid = None if pos is None else torch.from_numpy(pos // p)
    return flash.flash_attention(_fold(q), _fold(k), _fold(v), n_heads=h,
                                 mode=mode, tok_per_time=p, slab_ids=sid)


@pytest.mark.parametrize("n_full,n_keep,p", [(512, 256, 32),
                                             (1024, 256, 128)])
def test_k6_twin_matches_gathered_kernel_interpret(n_full, n_keep, p):
    b, h, d = 2, 2, 32
    pos = _sorted_subset(10, b, n_full, n_keep)
    q, k, v = _qkv(10, b, n_keep, h, d)
    want = block_attention.gathered_slab_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(pos), p, interpret=True)
    before = dict(flash.launches)
    out, _ = _twin("positions", q, k, v, h, p, pos)
    assert flash.launches == before          # CPU: the twin, no kernel
    np.testing.assert_allclose(_unfold(out, h), np.asarray(want),
                               atol=FWD_TOL)


@pytest.mark.parametrize("mode", ["dense", "slab"])
def test_k7_twin_matches_kernel_interpret(mode):
    """B=1, T=1024, H=4, D=32: the packed forward (``_fwd_packed``) that
    ``dense_flash_attention`` and ``slab_causal_attention`` take."""
    b, t, h, d, p = 1, 1024, 4, 32, 256
    q, k, v = _qkv(14, b, t, h, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if mode == "dense":
        want = block_attention.dense_flash_attention(jq, jk, jv, tile=256,
                                                     interpret=True)
    else:
        want = block_attention.slab_causal_attention(jq, jk, jv, p,
                                                     interpret=True)
    out, _ = _twin(mode, q, k, v, h, p if mode == "slab" else 0)
    np.testing.assert_allclose(_unfold(out, h), np.asarray(want),
                               atol=FWD_TOL)


@pytest.mark.parametrize("mode", ["dense", "slab", "positions"])
def test_twin_lse_matches_kernel_interpret(mode):
    """The per-row logsumexp the backward reads, against the per-head
    Pallas forward ``_fwd`` (its lse output) in interpret mode."""
    b, t, h, d, p = 1, 256, 2, 16, 32
    q, k, v = _qkv(3, b, t, h, d)
    to3 = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, d))
    pos = _sorted_subset(3, b, 4 * t, t) if mode == "positions" else None
    kw = dict(scale=1.0 / d ** 0.5, interpret=True, nh=h)
    if mode == "positions":
        slab = jnp.asarray(pos // p)
        kw.update(block=1, causal=False, pos=(slab[:, :, None],
                                              slab[:, None, :]))
    else:
        kw.update(block=p if mode == "slab" else 128,
                  causal=mode == "slab")
    _, want = block_attention._fwd(to3(q), to3(k), to3(v), **kw)
    _, lse = _twin(mode, q, k, v, h, p if mode != "dense" else 0, pos)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want).reshape(b, h, t),
                               atol=FWD_TOL)


def _jax_loss(fn, do):
    return lambda q, k, v: jnp.sum(fn(q, k, v) * jnp.asarray(do))


def _twin_grads(mode, q, k, v, do, h, p=0, pos=None):
    """(dq, dk, dv) of sum(out * do) through the twins, [B, T, H, D]."""
    tq, tk, tv, tdo = map(_fold, (q, k, v, do))
    sid = None if pos is None else torch.from_numpy(pos // p)
    kw = dict(n_heads=h, mode=mode, tok_per_time=p, slab_ids=sid)
    out, lse = flash.flash_attention(tq, tk, tv, **kw)
    before = dict(flash.launches_bwd)
    grads = flash.flash_attention_bwd(tq, tk, tv, out, lse, tdo, **kw)
    assert flash.launches_bwd == before
    return [_unfold(g, h) for g in grads]


def test_k6_twin_grads_match_gathered_kernel_interpret():
    b, n_full, n_keep, p, h, d = 1, 256, 128, 16, 2, 16
    pos = _sorted_subset(11, b, n_full, n_keep)
    q, k, v, do = _qkv(11, b, n_keep, h, d, n=4)
    fn = lambda q, k, v: block_attention.gathered_slab_attention(
        q, k, v, jnp.asarray(pos), p, interpret=True)
    want = jax.grad(_jax_loss(fn, do), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    got = _twin_grads("positions", q, k, v, do, h, p, pos)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["dense", "slab"])
def test_k7_twin_grads_match_kernel_interpret(mode):
    """B=1, T=256, H=2, D=16: the per-head backward ``_bwd`` (the packed
    plan needs 128 / D heads per group)."""
    b, t, h, d, p = 1, 256, 2, 16, 64
    q, k, v, do = _qkv(12, b, t, h, d, n=4)
    if mode == "dense":
        fn = lambda q, k, v: block_attention.dense_flash_attention(
            q, k, v, tile=128, interpret=True)
    else:
        fn = lambda q, k, v: block_attention.slab_causal_attention(
            q, k, v, p, interpret=True)
    want = jax.grad(_jax_loss(fn, do), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    got = _twin_grads(mode, q, k, v, do, h, p if mode == "slab" else 0)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_TOL,
                                   err_msg=name)


def _shuffled_slabs(b, t, p, seed):
    """Slab ids of unsorted positions: every row still sees its own key."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([rng.permutation(4 * t)[:t] // p
                                      for _ in range(b)]).astype(np.int32))


@pytest.mark.parametrize("mode,p", [("dense", 0), ("slab", 5),
                                    ("positions", 3)])
def test_function_gradcheck(mode, p):
    """``FlashAttention`` (twin forward, twin backward) in float64 against
    torch's numerical gradients; P need not divide T, and the positions
    need not be sorted."""
    b, t, h, d = 2, 12, 2, 4
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(b, t, h * d, generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    sid = _shuffled_slabs(b, t, p, 7) if mode == "positions" else None
    fn = lambda q, k, v: flash.FlashAttention.apply(q, k, v, sid, h, mode, p)
    assert torch.autograd.gradcheck(fn, (q, k, v))


def _plain_masked(q, k, v, h, allowed):
    """Plain differentiable attention over [B, T, E] with a [B|1, T, T]
    bool mask (None: dense)."""
    b, t, e = q.shape
    r = lambda x: x.reshape(b, t, h, e // h)
    logits = torch.einsum("bqhd,bkhd->bhqk", r(q), r(k)) / (e // h) ** 0.5
    if allowed is not None:
        logits = logits.masked_fill(~allowed[:, None], tattn.NEG_INF)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), r(v))
    return out.reshape(b, t, e)


@pytest.mark.parametrize("mode,p", [("dense", 0), ("slab", 16),
                                    ("positions", 8)])
def test_function_grads_match_autograd_of_plain_attention(mode, p):
    """B=2, T=300 (two twin row blocks, the second ragged), f32."""
    b, t, h, d = 2, 300, 2, 8
    gen = torch.Generator().manual_seed(8)
    q, k, v, do = (torch.randn(b, t, h * d, generator=gen) for _ in range(4))
    sid = None
    if mode == "positions":
        sid = _shuffled_slabs(b, t, p, 8)
        allowed = tmasks.block_causal_mask_from_positions(sid, sid, 1)
    elif mode == "slab":
        allowed = tmasks.block_causal_mask(t, p)[None]
    else:
        allowed = None
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash.FlashAttention.apply(*leaves, sid, h, mode, p)
    got = torch.autograd.grad(out, leaves, do)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want_out = _plain_masked(*leaves, h, allowed)
    want = torch.autograd.grad(want_out, leaves, do)
    torch.testing.assert_close(out, want_out, atol=FWD_TOL, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=GRAD_TOL, rtol=0)


def test_positions_mask_matches_jax():
    pos = _sorted_subset(4, 3, 200, 40)
    want = jmasks.block_causal_mask_from_positions(jnp.asarray(pos),
                                                   jnp.asarray(pos), 16)
    got = tmasks.block_causal_mask_from_positions(torch.from_numpy(pos),
                                                  torch.from_numpy(pos), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def routes(monkeypatch):
    """The modes ``flash_attention`` was called with (the K6 / K7 route)."""
    seen = []
    real = flash.flash_attention

    def spy(*args, mode, **kw):
        seen.append(mode)
        return real(*args, mode=mode, **kw)

    monkeypatch.setattr(flash, "flash_attention", spy)
    return seen


def _jax_route(q, k, v, **kw):
    return np.asarray(jattn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), impl="xla", **kw))


@pytest.mark.parametrize("case", ["gathered_slab", "slab", "dense_long"])
def test_routing_to_the_kernels(routes, case):
    """"gathered_slab" always, "slab" with Tq == Tk, and dense with
    Tq == Tk >= 2048 go to K6 / K7; the result is the JAX package's plain
    XLA attention's."""
    b, h, d, p = 1, 2, 8, 16
    t = 2048 if case == "dense_long" else 96
    q, k, v = _qkv(5, b, t, h, d)
    kw = {}
    if case == "gathered_slab":
        pos = _sorted_subset(5, b, 4 * t, t)
        kw = dict(mask_mode="gathered_slab", tok_per_time=p)
        jkw = dict(kw, positions=jnp.asarray(pos))
        kw["positions"] = torch.from_numpy(pos).long()
    elif case == "slab":
        kw = jkw = dict(mask_mode="slab", tok_per_time=p)
    else:
        jkw = {}
    got = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                      **kw)
    assert routes == [{"gathered_slab": "positions", "slab": "slab",
                       "dense_long": "dense"}[case]]
    np.testing.assert_allclose(got.numpy(), _jax_route(q, k, v, **jkw),
                               atol=FWD_TOL)


@pytest.mark.parametrize("case", ["dense_short", "perceiver_self",
                                  "cross", "slab_tq_ne_tk", "causal"])
def test_routing_keeps_the_plain_path(routes, case):
    """Dense below 2048 tokens (the Perceiver's 32-token self-attention),
    cross-attention (Tq != Tk, however long the context), slab with
    Tq != Tk and causal stay on the plain path."""
    h, d = 2, 8
    tq, tk, kw = {"dense_short": (256, 256, {}),
                  "perceiver_self": (32, 32, {}),
                  "cross": (32, 2048, {}),
                  "slab_tq_ne_tk": (40, 64, dict(mask_mode="slab",
                                                 tok_per_time=16)),
                  "causal": (64, 64, dict(mask_mode="causal"))}[case]
    q, = _qkv(6, 1, tq, h, d, n=1)
    k, v = _qkv(7, 1, tk, h, d, n=2)
    got = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                      **kw)
    assert routes == []
    np.testing.assert_allclose(got.numpy(), _jax_route(q, k, v, **kw),
                               atol=FWD_TOL)


def test_wrapper_refuses_unknown_modes_and_missing_ids():
    q = torch.zeros(1, 128, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="gathered_slab"):
        tattn.dot_product_attention(q.reshape(1, 128, 2, 32),
                                    q.reshape(1, 128, 2, 32),
                                    q.reshape(1, 128, 2, 32),
                                    mask_mode="gathered_slab",
                                    tok_per_time=8)
    with pytest.raises(ValueError, match="unknown mode"):
        flash._check(q, q, q, 2, "causal", 0, None)
    with pytest.raises(ValueError, match="slab_ids"):
        flash._check(q, q, q, 2, "positions", 8, None)


def test_supported_rejects_what_k6_k7_do_not_take():
    """On the card: f32, head_dim 16, T = 2400 and 600 kept tokens (an MAE
    of 100 channels); the MAE's 1536 kept and 6144 tokens pass, and the CPU
    twins take anything."""
    bf16, f32 = torch.bfloat16, torch.float32
    for t in (1536, 6144):
        assert flash.supported("cuda", bf16, t, 256, 8)
    assert not flash.supported("cuda", f32, 6144, 256, 8)
    assert not flash.supported("cuda", bf16, 6144, 128, 8)
    for t in (2400, 600):
        assert not flash.supported("cuda", bf16, t, 256, 8)
    assert flash.supported("cpu", f32, 12, 8, 2)


@pytest.mark.parametrize("case", ["gathered_slab", "slab", "dense_long"])
def test_plain_routes_match_jax_fallbacks(routes, monkeypatch, case):
    """With the K6 / K7 gate shut every mode runs the plain path, the
    "gathered_slab" mode with a [B, N, N] mask from the positions, and
    matches the JAX package's XLA fallbacks."""
    monkeypatch.setattr(flash, "supported", lambda *a: False)
    b, h, d, p = 2, 2, 8, 16
    t = 2048 if case == "dense_long" else 96
    q, k, v = _qkv(15, b, t, h, d)
    kw = jkw = {}
    if case == "gathered_slab":
        pos = _sorted_subset(15, b, 4 * t, t)
        kw = dict(mask_mode="gathered_slab", tok_per_time=p)
        jkw = dict(kw, positions=jnp.asarray(pos))
        kw["positions"] = torch.from_numpy(pos).long()
    elif case == "slab":
        kw = jkw = dict(mask_mode="slab", tok_per_time=p)
    got = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                      **kw)
    assert routes == []
    np.testing.assert_allclose(got.numpy(), _jax_route(q, k, v, **jkw),
                               atol=FWD_TOL)
