"""The port's padding masks and explicitly masked attention against the JAX
package's, on the CPU: ``padding_mask`` and ``self_attention_padding_mask``
(exact), ``dot_product_attention`` with a boolean ``mask`` in each shape
and mode, rows that see no key, a dense T at ``DENSE_FLASH_MIN`` (which
must not reach K7's route), and ``Block`` with an RMSNorm and a
prefix-aligned rope table, forward and gradients, with the weights
carried across by ``import_reference``'s block exporter. float32 on both
sides; inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.models import layers as jlayers
from frankenstein_tpu.models.import_reference import _export_block
from frankenstein_tpu.ops import attention as jattn
from frankenstein_tpu.ops import masks as jmasks
from frankenstein_tpu.ops import rope as jrope
from frankenstein_tpu_torch.models import layers as tlayers
from frankenstein_tpu_torch.models.weights import load_strict
from frankenstein_tpu_torch.ops import attention as tattn
from frankenstein_tpu_torch.ops import masks as tmasks
from frankenstein_tpu_torch.ops import rope as trope
from tests.test_torch_flash_attention import routes  # noqa: F401 (fixture)

torch.set_num_threads(1)

ATTN_TOL = 1e-5    # f32 attention, the plain ops' tolerance
GRAD_TOL = 1e-4    # absolute, as the MAE's gradients


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _padded(rng, b, t, c, pads):
    """[B, T, C] float32 whose timesteps ``pads[i]`` of sample i are all
    zero (padding)."""
    x = _rand(rng, b, t, c)
    for i, rows in enumerate(pads):
        x[i, rows] = 0.0
    return x


@pytest.mark.parametrize("pads", [[[], []], [[0, 3], [5, 6, 7]],
                                  [list(range(8)), [1]]])
def test_padding_masks_exact(pads):
    x = _padded(np.random.default_rng(0), 2, 8, 5, pads)
    x[0, 4, :2] = 0.0                   # a partly zero timestep is real
    want = jmasks.padding_mask(jnp.asarray(x))
    got = tmasks.padding_mask(torch.from_numpy(x))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tmasks.self_attention_padding_mask(got).numpy(),
        np.asarray(jmasks.self_attention_padding_mask(want)))


def test_padding_mask_pad_value():
    x = np.full((1, 4, 3), 7.0, np.float32)
    x[0, 1] = 1.0
    np.testing.assert_array_equal(
        tmasks.padding_mask(torch.from_numpy(x), pad_value=7.0).numpy(),
        np.asarray(jmasks.padding_mask(jnp.asarray(x), pad_value=7.0)))


def _masks(rng, b, tq, tk):
    """A random boolean mask of each shape the attention takes, and one
    with query rows that see no key at all."""
    full = rng.random((b, tq, tk)) < 0.6
    dead = full.copy()
    dead[0, 1] = False
    dead[-1, -1] = False
    return {"2d": full[0], "3d": full, "4d": full[:, None],
            "dead_rows": dead, "suffix": rng.random((b, tq + 3, tk + 2)) < .6}


@pytest.mark.parametrize("shape", ["2d", "3d", "4d", "dead_rows", "suffix"])
@pytest.mark.parametrize("mode,tq,p", [(None, 12, 0), ("causal", 12, 0),
                                       ("slab", 12, 4), ("slab", 7, 4)])
def test_explicit_mask_matches_jax(shape, mode, tq, p):
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, 2, tq, 3, 8), _rand(rng, 2, 12, 3, 8), \
        _rand(rng, 2, 12, 3, 8)
    mask = _masks(rng, 2, tq, 12)[shape]
    want = jattn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask), mask_mode=mode,
        tok_per_time=p)
    got = tattn.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask),
        mask_mode=mode, tok_per_time=p)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)


def test_a_row_that_sees_no_key_is_the_mean_of_v():
    """Every score of a padded query is finfo(f32).min: its softmax is
    uniform, finite, as in the JAX package (not NaN)."""
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, 1, 6, 2, 4) for _ in range(3))
    mask = np.ones((1, 6, 6), bool)
    mask[0, 2] = False
    got = tattn.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got[0, 2].numpy(), v[0].mean(axis=0),
                               atol=ATTN_TOL)
    want = jattn.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                       mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)


def test_gathered_slab_mask_is_anded_with_the_positions():
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, 2, 10, 2, 8) for _ in range(3))
    pos = np.sort(np.stack([rng.choice(40, 10, replace=False)
                            for _ in range(2)]), axis=-1)
    mask = rng.random((2, 10, 10)) < 0.7
    kw = dict(mask_mode="gathered_slab", tok_per_time=8)
    want = jattn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask),
        positions=jnp.asarray(pos), **kw)
    got = tattn.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask),
        positions=torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)


@pytest.mark.parametrize("mode", [None, "slab", "gathered_slab"])
def test_a_masked_call_never_takes_a_kernel_route(routes, mode):
    """Dense at T = DENSE_FLASH_MIN, "slab" and "gathered_slab" go to K6 /
    K7 without a mask; with one they run the plain path, as the JAX
    package sends them to XLA (K7 takes no mask)."""
    t = tattn.DENSE_FLASH_MIN if mode is None else 64
    rng = np.random.default_rng(4)
    q, k, v = (_rand(rng, 1, t, 1, 8) for _ in range(3))
    mask = np.ones((1, t, t), bool)
    mask[0, :, t // 2:] = rng.random((t, t - t // 2)) < 0.5
    mask[0, 3] = False
    kw = {}
    if mode == "slab":
        kw = dict(mask_mode="slab", tok_per_time=16)
    elif mode == "gathered_slab":
        kw = dict(mask_mode="gathered_slab", tok_per_time=16,
                  positions=np.arange(t)[None])
    tkw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    got = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                      mask=torch.from_numpy(mask), **tkw)
    assert routes == []
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    want = jattn.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                       mask=jnp.asarray(mask), **jkw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL)
    tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)), **tkw)
    assert routes == [{None: "dense", "slab": "slab",
                       "gathered_slab": "positions"}[mode]]


DIM, HEADS, HEAD_DIM, HIDDEN = 16, 2, 8, 32


def _block_pair(norm, align, seed=0):
    """(jax Block, its perturbed params, the port's Block with the same
    weights)."""
    rng = np.random.default_rng(seed)
    jblock = jlayers.Block(DIM, HEADS, HEAD_DIM, HIDDEN, norm=norm,
                           rope_align=align)
    params = jblock.init(jax.random.key(seed), jnp.ones((1, 4, DIM)))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    state = {}
    _export_block(state, "", jax.tree_util.tree_map(np.asarray,
                                                    params["params"]))
    block = load_strict(tlayers.Block(DIM, HEADS, HEAD_DIM, HIDDEN,
                                      norm=norm, rope_align=align), state)
    return jblock, params, block


@pytest.mark.parametrize("table", ["shared", "per_sample"])
@pytest.mark.parametrize("norm,align", [("rmsnorm", "prefix"),
                                        ("layernorm", "prefix"),
                                        ("rmsnorm", "suffix")])
def test_block_rope_align_and_mask_match_jax(norm, align, table):
    """A rope table longer than T (shared [S, D/2, 2] or per-sample
    [B, S, D/2, 2]) sliced at its prefix or suffix, with a padding mask:
    the output and every gradient."""
    rng = np.random.default_rng(5)
    t, s = 6, 10
    x = _padded(rng, 2, t, DIM, [[4], [0, 5]])
    valid = jmasks.padding_mask(jnp.asarray(x))
    mask = jmasks.self_attention_padding_mask(valid)
    cache = jrope.build_rope_cache(HEAD_DIM, 3 * s)
    if table == "shared":
        rope = cache[:s]
    else:
        pos = np.sort(np.stack([rng.choice(3 * s, s, replace=False)
                                for _ in range(2)]), axis=-1)
        rope = jrope.rope_for_positions(cache, jnp.asarray(pos))
    jblock, params, block = _block_pair(norm, align)

    def jloss(p):
        out = jblock.apply(p, jnp.asarray(x), mask=mask, rope=rope)
        return jnp.sum(out * out), out

    (jl, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    out = block(torch.from_numpy(x), mask=torch.tensor(np.asarray(mask)),
                rope=torch.tensor(np.asarray(rope)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATTN_TOL)
    torch.sum(out * out).backward()
    state = {}
    _export_block(state, "", jax.tree_util.tree_map(np.asarray,
                                                    jgrads["params"]))
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), state[name],
                                   atol=GRAD_TOL * max(1.0, np.abs(
                                       state[name]).max()), err_msg=name)


def test_prefix_and_suffix_differ_on_a_long_table():
    """The alignment is honoured: on a per-sample table of 12 irregular
    positions for 5 tokens the two slices give different outputs (a
    shared table's slices differ by a shift, which dense attention does
    not see)."""
    rng = np.random.default_rng(6)
    x = _rand(rng, 1, 5, DIM)
    pos = torch.from_numpy(np.sort(rng.choice(40, 12, replace=False)))
    table = trope.rope_for_positions(trope.build_rope_cache(HEAD_DIM, 40),
                                     pos[None])
    outs = [_block_pair("rmsnorm", align)[2](torch.from_numpy(x),
                                             rope=table).detach()
            for align in ("prefix", "suffix")]
    assert not torch.allclose(*outs)


@pytest.mark.parametrize("case", ["mask", "prefix_long", "per_sample"])
def test_k1_route_needs_no_mask_and_a_suffix_table(monkeypatch, case):
    """SelfAttention's slab mode takes K1's route only without a mask and
    with a shared table that is suffix-aligned or exactly T long (the JAX
    gate); otherwise apply_rope + the plain slab attention."""
    calls = []
    real = tattn.slab_attention_rope_fused
    monkeypatch.setattr(tattn, "slab_attention_rope_fused",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rng = np.random.default_rng(7)
    t = 8
    x = torch.from_numpy(_rand(rng, 1, t, DIM))
    attn = tlayers.SelfAttention(DIM, HEADS, HEAD_DIM,
                                 rope_align="suffix" if case == "mask"
                                 else "prefix")
    table = trope.build_rope_cache(HEAD_DIM, 2 * t)
    kw = dict(mask_mode="slab", tok_per_time=4, rope=table)
    if case == "mask":
        kw["mask"] = torch.ones(1, t, t, dtype=torch.bool)
    elif case == "per_sample":
        kw["rope"] = table[None, :t].expand(1, -1, -1, -1)
    attn(x, **kw)
    assert calls == []
    if case == "prefix_long":       # a table of exactly T rows is K1's
        attn(x, **dict(kw, rope=table[:t]))
        assert calls == [1]
