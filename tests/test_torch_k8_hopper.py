"""K8's Hopper kernel (``csrc/lm_head_topk.cu``) from the CPU. The kernel
runs only on the card; here its selection is mirrored in numpy and held to
the plain twin and to the JAX package:

- the walk: G CTAs over contiguous ascending ranges of 128-row vocab
  blocks (``[c nblk / G, (c + 1) nblk / G)``); in each block a row's
  logits are drawn best first (the largest value, then the lowest index)
  while the drawn one beats the row's k-th entry, and inserted into the
  row's sorted list; the rows past V never enter; each CTA keeps the row's
  running max and its lanes' sums of exp, rescaled when the max moves;
- the merge: k rounds of an argmax over the heads of the G sorted lists,
  logz = mg + log(sum_c se_c exp(m_c - mg));
- held against ``exact_topk`` and ``torch.logsumexp`` on random logits,
  against the JAX ``lm_head_topk`` in Pallas interpret mode, and on
  adversarial ties (equal logits across CTA ranges, at a list's threshold,
  in the vocab tail);
- the wrapper's kept scratch and f32 parameter copies, and its plan of the
  kernel's shared memory at every k.
Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.ops.pallas import lm_head_topk as jk8
from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8

torch.set_num_threads(1)

VB = k8.VB          # vocab rows a block
LANES = 32          # a warp: four logits a lane and block


def _ranges(nblk: int, grid: int):
    """Each CTA's vocab blocks, as the kernel splits them."""
    return [range(c * nblk // grid, (c + 1) * nblk // grid)
            for c in range(grid)]


def _cta_walk(logits, blocks, k: int):
    """One CTA's walk over its blocks for every batch row: (lists [B] of k
    (value, index) pairs in (value desc, index asc) order, m [B], se [B]).
    Drawn best first while the draw beats the list's k-th entry."""
    b, v = logits.shape
    lists = [[] for _ in range(b)]
    m = np.full(b, -np.inf)
    lane_se = np.zeros((b, LANES))
    for blk in blocks:
        v0 = blk * VB
        cols = np.arange(v0, min(v0 + VB, v))
        for row in range(b):
            x = logits[row, cols].astype(np.float64)
            m1 = max(m[row], x.max())
            lanes = (cols - v0) % LANES
            lane_se[row] *= np.exp(m[row] - m1)
            np.add.at(lane_se[row], lanes, np.exp(x - m1))
            m[row] = m1
            left = sorted(zip(-x, cols))          # best first
            lst = lists[row]
            for negval, idx in left:
                entry = (-negval, int(idx))
                if len(lst) == k and not _ahead(entry, lst[-1]):
                    break
                lst.append(entry)
                lst.sort(key=lambda e: (-e[0], e[1]))
                del lst[k:]
    return lists, m, lane_se.sum(1)


def _ahead(a, b) -> bool:
    """(value, index) a ranks before b: larger value, then lower index."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _kernel_model(logits, k: int, grid: int):
    """The kernel's (vals, idx, logz) on [B, V] logits, over ``grid`` CTAs."""
    b, v = logits.shape
    nblk = -(-v // VB)
    grid = min(grid, nblk)
    walks = [_cta_walk(logits, blocks, k) for blocks in _ranges(nblk, grid)]
    vals = np.zeros((b, k))
    idx = np.zeros((b, k), np.int64)
    logz = np.zeros(b)
    for row in range(b):
        heads = [0] * grid
        for r in range(k):
            best, owner = None, -1
            for c, (lists, _, _) in enumerate(walks):
                lst = lists[row]
                if heads[c] < len(lst) and (
                        best is None or _ahead(lst[heads[c]], best)):
                    best, owner = lst[heads[c]], c
            heads[owner] += 1
            vals[row, r], idx[row, r] = best
        ms = np.array([w[1][row] for w in walks])
        ses = np.array([w[2][row] for w in walks])
        mg = ms.max()
        logz[row] = mg + np.log((ses * np.exp(ms - mg)).sum())
    return vals, idx, logz


def _logits(seed: int, b: int, v: int, scale: float = 3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, v)) * scale).astype(np.float32)


@pytest.mark.parametrize("b,v,k,grid", [(3, 1000, 10, 4), (2, 3000, 5, 7),
                                        (4, 777, 32, 3), (1, 640, 1, 5),
                                        (2, 129, 10, 2), (3, 2048, 16, 16)])
def test_walk_and_merge_give_the_exact_topk_and_logsumexp(b, v, k, grid):
    """Any grid, a ragged tail (777, 129), k from 1 to 32: the model's top-k
    is ``exact_topk``'s, its logz ``torch.logsumexp``'s."""
    logits = _logits(b * v + k, b, v)
    vals, idx, logz = _kernel_model(logits, k, grid)
    want_v, want_i = k8.exact_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(idx, want_i.numpy())
    np.testing.assert_array_equal(vals, want_v.numpy().astype(np.float64))
    np.testing.assert_allclose(
        logz, torch.logsumexp(torch.from_numpy(logits).double(), -1).numpy(),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["across CTAs", "at the threshold",
                                  "in the tail", "all equal"])
def test_ties_go_to_the_lowest_index(case):
    """Equal logits in different CTAs' ranges, a later block's logit equal
    to a list's k-th entry (it must not displace it), equal logits in the
    last, ragged block, and a row of one value: the model agrees with the
    stable sort at every position."""
    b, v, k, grid = 2, 1100, 6, 4
    logits = _logits(7, b, v)
    top = float(logits.max()) + 1.0
    if case == "across CTAs":      # blocks 0, 2, 4 and 8 lie in 4 ranges
        logits[:, [3, 300, 520, 1050]] = top
    elif case == "at the threshold":
        logits[:, :] = np.minimum(logits, 0.0)
        logits[:, [5, 6, 7, 8, 9, 10]] = top          # block 0 fills the list
        logits[:, [140, 141]] = top                   # block 1 ties it
    elif case == "in the tail":
        logits[:, [1030, 1031, 1099, 1098]] = top
        logits[:, 20] = top
    else:
        logits[:, :] = 1.5
    vals, idx, logz = _kernel_model(logits, k, grid)
    want_v, want_i = k8.exact_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(idx, want_i.numpy())
    np.testing.assert_array_equal(vals, want_v.numpy().astype(np.float64))
    assert np.isfinite(logz).all()


def test_model_matches_the_pallas_kernel_interpret():
    """The same x, ln_w, ln_b and table: the model on the twin's logits and
    the JAX ``lm_head_topk`` (its per-chunk candidates reduced by
    ``lax.top_k``) give the same indices; vals and logz within 1e-5."""
    rng = np.random.default_rng(3)
    b, e, v, k = 4, 128, 640, 8
    x = rng.standard_normal((b, e)).astype(np.float32)
    ln_w = (rng.standard_normal(e) * 0.1 + 1).astype(np.float32)
    ln_b = (rng.standard_normal(e) * 0.1).astype(np.float32)
    wte = (rng.standard_normal((v, e)) * 0.05).astype(np.float32)
    jv, ji, jz = jk8.lm_head_topk(
        jnp.asarray(x), jnp.asarray(ln_w), jnp.asarray(ln_b),
        jnp.asarray(wte.T), k=k, chunk=128, interpret=True)
    top, pos = jax.lax.top_k(jv, k)
    want_i = np.asarray(jnp.take_along_axis(ji, pos, 1))
    logits = k8.head_logits_ref(*(torch.from_numpy(a)
                                  for a in (x, ln_w, ln_b, wte))).numpy()
    vals, idx, logz = _kernel_model(logits, k, grid=3)
    np.testing.assert_array_equal(idx, want_i)
    np.testing.assert_allclose(vals, np.asarray(top), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logz, np.asarray(jz), rtol=1e-5, atol=1e-5)


def test_draws_per_block_stop_at_k():
    """A block inserts at most k logits into a row's list and none once the
    list's k-th entry beats its best: the walk's cost bound."""
    logits = _logits(11, 1, 4 * VB)
    inserted = []
    lst = []
    for blk in range(4):
        cols = np.arange(blk * VB, (blk + 1) * VB)
        n = 0
        for negval, i in sorted(zip(-logits[0, cols].astype(np.float64),
                                    cols)):
            e = (-negval, int(i))
            if len(lst) == 10 and not _ahead(e, lst[-1]):
                break
            lst = sorted(lst + [e], key=lambda z: (-z[0], z[1]))[:10]
            n += 1
        inserted.append(n)
    assert inserted[0] == 10 and all(n <= 10 for n in inserted)
    assert sum(inserted[1:]) < 30


def test_scratch_is_kept_for_a_shape():
    """Repeated calls of one shape get the same scratch tensors (no
    allocation); another shape, or another stream, gets its own; the
    barrier starts at zero."""
    cpu = torch.device("cpu")
    first = k8._scratch(cpu, 8, 768, 10, 132)
    again = k8._scratch(cpu, 8, 768, 10, 132)
    assert all(a is b for a, b in zip(first, again))
    h, cand, part, bar = first
    assert h.shape == (8, 768) and h.dtype == torch.bfloat16
    assert cand.shape == (8, 132, 10, 2) and cand.dtype == torch.int32
    assert part.shape == (8, 132, 2) and not bar.any()
    odd = k8._scratch(cpu, 8, 768, 9, 132)[1]
    assert odd.shape == (8, 132, 10, 2)       # k rounded up to even
    assert k8._scratch(cpu, 16, 768, 10, 132)[0] is not h
    assert k8._scratch(cpu, 8, 768, 10, 132, stream=7)[0] is not h


def test_f32_norm_parameters_are_kept_until_they_change():
    """f32 parameters pass as they are; a bf16 parameter's f32 copy is made
    once and kept, and made anew once the parameter changes in place; a
    missing bias is one kept zero vector."""
    cpu = torch.device("cpu")
    w32 = torch.ones(64)
    assert k8._as_f32(w32, 64, cpu) is w32
    w = torch.ones(64, dtype=torch.bfloat16)
    copy = k8._as_f32(w, 64, cpu)
    assert copy.dtype == torch.float32 and k8._as_f32(w, 64, cpu) is copy
    w.mul_(2)
    fresh = k8._as_f32(w, 64, cpu)
    assert fresh is not copy and float(fresh[0]) == 2.0
    zeros = k8._as_f32(None, 64, cpu)
    assert k8._as_f32(None, 64, cpu) is zeros and not zeros.any()


@pytest.mark.parametrize("k", range(1, 33))
def test_plan_fits_every_k(k):
    """At every k the plan of each batch width keeps at least two ring
    stages within a CTA's shared memory, with room for a merged row's
    lists on the widest grid; more batch rows never take more stages."""
    stages = []
    for b in k8.WIDTHS:
        n, st, smem = k8._plan(b, k, k8.MAX_GRID)
        assert n == b and 2 <= st <= 8 and smem <= k8.SMEM_MAX
        stages.append(st)
    assert stages == sorted(stages, reverse=True)
