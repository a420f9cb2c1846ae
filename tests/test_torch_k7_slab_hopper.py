"""K7 slab's wgmma passes (``csrc/flash_attention_dense.cu``, mode slab)
from the CPU. The kernels run only on the card; here their arithmetic
schedule is mirrored in Python and held to the mask and to the JAX
package:

- the tile ranges: each CTA's producer streams the keys up to the end of
  its last row's slab (the dk/dv pass: the query tiles from its first
  key's slab start); each warpgroup visits those up to its own last row's
  slab end (from its own first key's slab start) and passes the rest;
  only the MASKED instance compares per element, on the tiles that cross
  the warpgroup's slab boundary. Held against
  ``masks.block_causal_mask_from_positions`` for P in {1, 8, 64, 96, 256,
  6144} and T in {128, 384, 6144} at both head dims: every visible pair
  visited, no visible pair passed, every unmasked tile wholly visible, the
  element compare equal to the mask, and no compare at all where
  ``slab_masked`` says the unmasked instance runs. The shapes (warpgroups,
  tiles) are read from the source's ``FwdOf`` / ``DqOf`` / ``DkvOf``;
- the forward's exp2 online softmax and both backward passes over those
  walks in float64, against the JAX ``slab_causal_attention`` in Pallas
  interpret mode (forward and VJP) and against the plain twins;
- the slab kernels' names fall in ``chip_smoke.py``'s K7 families.
Inputs come from numpy seeds."""

import importlib.util
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.ops.pallas import block_attention
from frankenstein_tpu_torch.ops import masks
from frankenstein_tpu_torch.ops.cuda import flash_attention as k67

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "frankenstein_tpu_torch" / "csrc" / "flash_attention_dense.cu"
FWD_TOL, GRAD_TOL = 3e-5, 1e-4   # tests/test_attention.py's
NEG = float(np.finfo(np.float32).min)
PASS_SHAPES = {"fwd": "FwdOf", "dq": "DqOf", "dkv": "DkvOf"}


def _shape(name: str, d: int) -> tuple:
    """(consumer warpgroups, column tile) of the source's ``name`` shape at
    head_dim d."""
    line = re.search(rf"using {name} = \w+<D, ([^;]*)>;",
                     SOURCE.read_text()).group(1)
    pick = lambda m: m.group(1) if d == 32 else m.group(2)
    args = re.sub(r"D == 32 \? (\d+) : (\d+)", pick, line).split(",")
    return int(args[0]), int(args[1])


def _key_end(row: int, t: int, p: int) -> int:
    return min(t, (row // p + 1) * p)


def _row_walk(t, p, nwg, bn, masked):
    """The forward's and the dq pass's walk: per (CTA, warpgroup) its first
    row, the key tiles it visits [(j, compares per element)], the tiles it
    passes, and the CTA's streamed count."""
    out = []
    for q0 in range(0, t, 64 * nwg):
        nk = -(-_key_end(min(q0 + 64 * nwg, t) - 1, t, p) // bn)
        for cw in range(nwg):
            first = q0 + 64 * cw
            nkw = -(-_key_end(first + 63, t, p) // bn) if first < t else 0
            mask_from = (first // p + 1) * p
            tiles = [(j, masked and (j + 1) * bn > mask_from)
                     for j in range(nkw)]
            out.append((first, tiles, list(range(nkw, nk)), nk))
    return out


def _key_walk(t, p, nwg, bn, masked):
    """The dk/dv pass's walk: per (CTA, warpgroup) its first key, the query
    tiles it visits [(i, compares per element)], the tiles it passes and
    the CTA's first streamed tile."""
    nq, out = t // bn, []
    for j0 in range(0, t, 64 * nwg):
        i0 = (j0 // p) * p // bn
        for cw in range(nwg):
            first = j0 + 64 * cw
            iw = (first // p) * p // bn if first < t else nq
            mask_below = ((first + 63) // p) * p
            tiles = [(i, masked and i * bn < mask_below)
                     for i in range(iw, nq)]
            out.append((first, tiles, list(range(i0, min(iw, nq))), i0))
    return out


def _visible(t, p):
    pos = torch.arange(t)
    return masks.block_causal_mask_from_positions(pos, pos, p).numpy()


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("p", [1, 8, 64, 96, 256, 6144])
@pytest.mark.parametrize("t", [128, 384, 6144])
def test_walks_visit_every_visible_pair(t, p, d):
    """Both instances of the three passes against the slab-causal mask."""
    vis = _visible(t, p)
    for pass_, name in PASS_SHAPES.items():
        nwg, bn = _shape(name, d)
        unmasked = not k67.slab_masked(p, pass_, d)
        for masked in (True, False) if unmasked else (True,):
            if pass_ == "dkv":
                walk, seen = _key_walk(t, p, nwg, bn, masked), vis.T
            else:
                walk, seen = _row_walk(t, p, nwg, bn, masked), vis
            for first, tiles, passed, start in walk:
                if first >= t:
                    assert not tiles
                    continue
                rows = seen[first:first + 64]      # [64 rows, T columns]
                lo = tiles[0][0] * bn if tiles else t
                hi = (tiles[-1][0] + 1) * bn if tiles else 0
                if pass_ == "dkv":                 # visits [iw, nq)
                    assert hi == t and not rows[:, :lo].any()
                    assert start <= (lo // bn if tiles else t // bn)
                    assert passed == list(range(start, lo // bn))
                else:                              # visits [0, nkw)
                    assert not rows[:, hi:].any()
                    assert start * bn >= hi        # the CTA streams them
                    assert passed == list(range(hi // bn, start))
                for j, compares in tiles:
                    block = rows[:, j * bn:(j + 1) * bn]
                    assert compares or block.all(), (pass_, first, j)
                    if compares:                   # the kernels' predicates
                        q = np.arange(first, first + 64)[:, None]
                        kk = np.arange(j * bn, (j + 1) * bn)[None, :]
                        if pass_ == "dkv":         # rows are keys here
                            q, kk = kk, q
                        np.testing.assert_array_equal(
                            kk < np.minimum(t, (q // p + 1) * p), block)


@pytest.mark.parametrize("p", [64, 128, 256, 384, 6144])
def test_unmasked_instance_wherever_p_is_a_tile_multiple(p):
    """``slab_masked`` (the wrapper's mirror of the source's ``unmasked``)
    runs the compare-free instance exactly where P is a multiple of 64 and
    of the pass's tile: the forward's 128-key tiles at D=64 need P % 128."""
    for d in (32, 64):
        for pass_, name in PASS_SHAPES.items():
            bn = _shape(name, d)[1]
            want = p % 64 != 0 or p % bn != 0
            assert k67.slab_masked(p, pass_, d) == want
    assert k67.slab_masked(96, "fwd", 32) and k67.slab_masked(8, "dq", 64)


def _exp2_forward(q, k, v, p, nwg, bn, masked):
    """The forward kernel's arithmetic over its walk in float64, one head:
    raw scores s, finfo(f32).min on masked tiles' invisible pairs, the
    running max in log2 units, lse = (m + log2 l) * ln 2. q, k, v: [T, D]."""
    t, d = q.shape
    c = math.log2(math.e) / math.sqrt(d)
    out, lse = np.zeros((t, d)), np.zeros(t)
    for first, tiles, _, _ in _row_walk(t, p, nwg, bn, masked):
        if first >= t:
            continue
        rows = np.arange(first, first + 64)
        m = np.full((64, 1), -np.inf)
        l, o = np.zeros((64, 1)), np.zeros((64, d))
        for j, compares in tiles:
            cols = np.arange(j * bn, (j + 1) * bn)
            s = q[rows] @ k[cols].T
            if compares:
                s = np.where(cols[None, :] < np.minimum(
                    t, (rows[:, None] // p + 1) * p), s, NEG)
            new = np.maximum(m, s.max(-1, keepdims=True) * c)
            a = np.where(new == m, 1.0, np.exp2(m - new))
            pr = np.exp2(s * c - new)
            l = l * a + pr.sum(-1, keepdims=True)
            o = o * a + pr @ v[cols]
            m = new
        out[rows] = o / l
        lse[rows] = ((m + np.log2(l)) * math.log(2.0))[:, 0]
    return out, lse


def _backward(q, k, v, dout, lse, p, shapes, masked):
    """Both backward passes over their walks in float64, one head: the dq
    pass (rows walk key tiles) and the dk/dv pass (keys walk query tiles),
    p = exp(s scale - lse) at 0 where masked, ds = p (dp - delta) scale."""
    t, d = q.shape
    scale = 1.0 / math.sqrt(d)
    out = np.zeros_like(q)
    delta = np.zeros(t)
    vis = _visible(t, p)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)

    def grads(rows, cols):
        s = q[rows] @ k[cols].T * scale
        pr = np.where(vis[np.ix_(rows, cols)], np.exp(s - lse[rows, None]),
                      0.0)
        dp = dout[rows] @ v[cols].T
        return pr, pr * (dp - delta[rows, None]) * scale

    o_ref = _exp2_forward(q, k, v, p, *shapes["fwd"], masked)[0]
    delta[:] = (o_ref * dout).sum(-1)
    for first, tiles, _, _ in _row_walk(t, p, *shapes["dq"], masked):
        if first >= t:
            continue
        rows = np.arange(first, first + 64)
        for j, _ in tiles:
            cols = np.arange(j * shapes["dq"][1], (j + 1) * shapes["dq"][1])
            dq[rows] += grads(rows, cols)[1] @ k[cols]
    for first, tiles, _, _ in _key_walk(t, p, *shapes["dkv"], masked):
        if first >= t:
            continue
        cols = np.arange(first, first + 64)
        for i, _ in tiles:
            rows = np.arange(i * shapes["dkv"][1],
                             (i + 1) * shapes["dkv"][1])
            pr, ds = grads(rows, cols)
            dv[cols] += pr.T @ dout[rows]
            dk[cols] += ds.T @ q[rows]
    return dq, dk, dv


def _qkv(seed, t, h, d, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, t, h, d)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("t,p,d", [(256, 64, 32), (384, 96, 32),
                                   (256, 8, 64), (384, 1, 32),
                                   (256, 256, 64)])
def test_exp2_forward_matches_kernel_interpret_and_twin(t, p, d):
    """The mirror of the forward (the masked instance, and the unmasked one
    where it runs) against the JAX ``slab_causal_attention`` in interpret
    mode and the plain twin, head by head."""
    h = 2
    q, k, v = _qkv(t + p + d, t, h, d)
    want = np.asarray(block_attention.slab_causal_attention(
        *map(jnp.asarray, (q, k, v)), p, interpret=True))[0]
    fold = lambda x: torch.from_numpy(x).reshape(1, t, h * d)
    twin, twin_lse = k67.flash_attention_ref(fold(q), fold(k), fold(v),
                                             n_heads=h, mode="slab",
                                             tok_per_time=p)
    nwg, bn = _shape("FwdOf", d)
    for masked in {True, k67.slab_masked(p, "fwd", d)}:
        for i in range(h):
            out, lse = _exp2_forward(*(x[0, :, i].astype(np.float64)
                                       for x in (q, k, v)), p, nwg, bn,
                                     masked)
            np.testing.assert_allclose(out, want[:, i], atol=FWD_TOL)
            np.testing.assert_allclose(
                out, twin.reshape(t, h, d)[:, i].numpy(), atol=FWD_TOL)
            np.testing.assert_allclose(lse, twin_lse[0, i].numpy(),
                                       atol=FWD_TOL)


@pytest.mark.parametrize("t,p,d", [(256, 64, 32), (384, 96, 32),
                                   (256, 8, 64), (128, 1, 32)])
def test_backward_walks_match_kernel_vjp_interpret(t, p, d):
    """The mirror of the dq and dk/dv passes against ``jax.grad`` through
    the JAX ``slab_causal_attention`` in interpret mode and against the
    plain twin's backward."""
    h = 2
    q, k, v, do = _qkv(3 * t + p, t, h, d, n=4)
    loss = lambda a, b_, c: jnp.sum(block_attention.slab_causal_attention(
        a, b_, c, p, interpret=True) * jnp.asarray(do))
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    shapes = {pas: _shape(name, d) for pas, name in PASS_SHAPES.items()}
    fold = lambda x: torch.from_numpy(x).reshape(1, t, h * d)
    out, lse = k67.flash_attention_ref(fold(q), fold(k), fold(v), n_heads=h,
                                       mode="slab", tok_per_time=p)
    twin = k67.flash_attention_bwd_ref(fold(q), fold(k), fold(v), out, lse,
                                       fold(do), n_heads=h, mode="slab",
                                       tok_per_time=p)
    for i in range(h):
        x64 = [x[0, :, i].astype(np.float64) for x in (q, k, v, do)]
        _, lse64 = _exp2_forward(*x64[:3], p, *shapes["fwd"], True)
        got = _backward(*x64, lse64, p, shapes, True)
        for name, g, w, tw in zip("qkv", got, want, twin):
            np.testing.assert_allclose(g, np.asarray(w)[0, :, i],
                                       atol=GRAD_TOL, err_msg=name)
            np.testing.assert_allclose(
                g, tw.reshape(t, h, d)[:, i].numpy(), atol=GRAD_TOL,
                err_msg=name)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,family", zip(
    k67.SLAB_KERNELS, ("K7 fwd", "K7 bwd dq", "K7 bwd dk/dv")))
def test_slab_kernels_fall_in_their_profile_families(name, family):
    """The profile attributes the slab passes' device time to K7's
    families, never to K6's or K1's."""
    smoke = _chip_smoke()
    for form in (name, f"void (anonymous namespace)::{name}<(anonymous "
                       f"namespace)::Slab<(anonymous namespace)::Fwd<32, 2, "
                       f"64, 2>, true> >(CUtensorMap_st)"):
        assert smoke._family(form) == family


def test_slab_kernels_are_the_sources():
    """The three slab kernels are ``__global__`` functions of the dense
    source, and the mma.sync sources they replace are gone: no source
    issues an mma.sync."""
    text = SOURCE.read_text()
    for name in k67.SLAB_KERNELS:
        assert re.search(rf"__global__\s+void\s+__launch_bounds__"
                         rf"\([^)]*\)\s+{name}\(", text), name
    csrc = SOURCE.parent
    assert not (csrc / "flash_attention.cu").exists()
    assert not (csrc / "flash_attention_bwd.cu").exists()
    assert "mma.sync.aligned" not in "".join(
        f.read_text() for f in csrc.glob("*.cu*"))
