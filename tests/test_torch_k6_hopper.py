"""K6's wgmma kernels (``csrc/flash_attention_dense.cu``, mode positions)
from the CPU. The kernels run only on the card; here their schedule and
arithmetic are mirrored in Python and held to the JAX package:

- the staircase each pass walks, taken from the slab ids: per column tile
  its least and greatest id; per consumer warpgroup each streamed tile
  skipped, unmasked or masked; the producer's list the union of the
  warpgroups'. Over sorted and shuffled ids, every visible (query, key)
  pair is visited exactly once, no unmasked tile holds an invisible pair,
  and the forward's and the dk/dv pass's walks cover the same pairs. The
  shapes (warpgroups, tiles) are read from the source's ``Pos*Of`` lines;
- the forward's exp2 online softmax over that walk in float64, masked
  scores at finfo(f32).min and a row that has seen only masked scores held
  at 0, against the plain twin (``flash_attention_ref``) and the JAX
  package's gathered kernel in interpret mode (``gathered_slab_attention``,
  sorted positions as it takes them), tolerance 3e-5 (that of
  ``tests/test_attention.py``);
- the kernels' names fall in ``chip_smoke.py``'s K6 profile families.
Inputs come from numpy seeds."""

import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.ops.pallas import block_attention
from frankenstein_tpu_torch.ops.cuda import flash_attention as k67

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "frankenstein_tpu_torch" / "csrc" / "flash_attention_dense.cu"
FWD_TOL = 3e-5
NEG = float(np.finfo(np.float32).min)
NO_KEY_YET = -1e30   # hopper_blocks.cuh: kNoKeyYet
FAMILIES = dict(zip(k67.POSITIONS_KERNELS,
                    ("K6 fwd", "K6 bwd dq", "K6 bwd dk/dv")))
CONFIGS = dict(zip(k67.POSITIONS_KERNELS, ("FwdPos", "DqPos", "DkvPos")))


def _shape(name: str, d: int) -> tuple:
    """(consumer warpgroups, column tile) of the source's ``name`` shape
    (PosFwdOf, PosDqOf, PosDkvOf) at head_dim d."""
    line = re.search(rf"using {name} = \w+<D, ([^;]*)>;",
                     SOURCE.read_text()).group(1)
    pick = lambda m: m.group(1) if d == 32 else m.group(2)
    args = re.sub(r"D == 32 \? (\d+) : (\d+)", pick, line).split(",")
    return int(args[0]), int(args[1])


def _slab_ids(order: str, n: int, p: int, seed: int) -> np.ndarray:
    """[n] int32 slab ids: kept positions of a 4x longer window // p,
    sorted or shuffled, or "first tile unseen": ids in [0, 4) whose first
    128 keys hold the greatest."""
    rng = np.random.default_rng(seed)
    if order == "first tile unseen":
        sid = rng.integers(0, 4, n).astype(np.int32)
        sid[:128] = 3
        return sid
    pos = rng.choice(4 * n, size=n, replace=False)
    pos = np.sort(pos) if order == "sorted" else pos
    return (pos // p).astype(np.int32)


def _ranges(sid, bn):
    tiles = sid.reshape(-1, bn)
    return tiles.min(1), tiles.max(1)


def _row_walk(sid, nwg, bn):
    """The forward's and the dq pass's walk: per (CTA, warpgroup) its
    first row and [(key tile, kind)] over the tiles the producer streams,
    kind "skip", "unmasked" or "masked"; and per CTA the streamed tiles."""
    t = len(sid)
    lo, hi = _ranges(sid, bn)
    bm = 64 * nwg
    for q0 in range(0, t, bm):
        cta_hi = sid[q0:q0 + bm].max()
        streamed = [j for j in range(t // bn) if lo[j] <= cta_hi]
        walks = []
        for cw in range(nwg):
            first = q0 + 64 * cw
            if first >= t:
                walks.append((first, [(j, "skip") for j in streamed]))
                continue
            wlo, whi = sid[first:first + 64].min(), sid[first:first + 64].max()
            walks.append((first, [
                (j, "skip" if lo[j] > whi else
                 "unmasked" if hi[j] <= wlo else "masked")
                for j in streamed]))
        yield streamed, walks


def _key_walk(sid, nwg, bn):
    """The dk/dv pass's walk: per (CTA, warpgroup of 64 keys) its first key
    and [(query tile, kind)] over the streamed tiles; per CTA those."""
    t = len(sid)
    lo, hi = _ranges(sid, bn)
    bm = 64 * nwg
    for j0 in range(0, t, bm):
        cta_lo = sid[j0:j0 + bm].min()
        streamed = [i for i in range(t // bn) if hi[i] >= cta_lo]
        walks = []
        for cw in range(nwg):
            first = j0 + 64 * cw
            if first >= t:
                walks.append((first, [(i, "skip") for i in streamed]))
                continue
            klo, khi = sid[first:first + 64].min(), sid[first:first + 64].max()
            walks.append((first, [
                (i, "skip" if hi[i] < klo else
                 "unmasked" if lo[i] >= khi else "masked")
                for i in streamed]))
        yield streamed, walks


def _coverage(sid, walk, bn, keys_are_rows: bool):
    """[T, T] (query, key) visit counts of a walk; asserts each unmasked
    tile holds only visible pairs and the producer streams exactly the
    union of its warpgroups' tiles."""
    t = len(sid)
    visible = sid[None, :] <= sid[:, None]
    count = np.zeros((t, t), np.int32)
    for streamed, walks in walk:
        seen = set()
        for first, tiles in walks:
            for j, kind in tiles:
                if kind == "skip":
                    continue
                seen.add(j)
                rows = slice(first, first + 64)
                cols = slice(j * bn, (j + 1) * bn)
                q_sl, k_sl = (cols, rows) if keys_are_rows else (rows, cols)
                count[q_sl, k_sl] += 1
                if kind == "unmasked":
                    assert visible[q_sl, k_sl].all(), (first, j)
        assert seen == set(streamed)
    return count, visible


ORDERS = ["sorted", "shuffled"]


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("p", [16, 40, 256])
@pytest.mark.parametrize("n", [256, 384, 1536])
@pytest.mark.parametrize("order", ORDERS)
def test_walks_visit_every_visible_pair_once(order, n, p, d):
    sid = _slab_ids(order, n, p, seed=n + p + d)
    walks = {}
    for name, walk, keys in (("PosFwdOf", _row_walk, False),
                             ("PosDqOf", _row_walk, False),
                             ("PosDkvOf", _key_walk, True)):
        nwg, bn = _shape(name, d)
        count, visible = _coverage(sid, walk(sid, nwg, bn), bn, keys)
        assert (count <= 1).all(), name
        assert (count[visible] == 1).all(), name
        walks[name] = count.astype(bool) & visible
    assert (walks["PosFwdOf"] == walks["PosDkvOf"]).all()
    assert (walks["PosDqOf"] == walks["PosDkvOf"]).all()


def test_sorted_walk_ends_at_the_staircase():
    """Sorted ids: each warpgroup's visited tiles are a prefix of the
    stream and the producer streams a prefix of the key tiles."""
    sid = _slab_ids("sorted", 1536, 256, seed=1)
    nwg, bn = _shape("PosFwdOf", 32)
    for streamed, walks in _row_walk(sid, nwg, bn):
        assert streamed == list(range(len(streamed)))
        for _, tiles in walks:
            kinds = [kind for _, kind in tiles]
            visited = [k != "skip" for k in kinds]
            assert visited == sorted(visited, reverse=True)


def _exp2_walk(q, k, v, sid, nwg, bn):
    """The forward kernel's arithmetic over its walk in float64, one head:
    raw scores s, masked ones at finfo(f32).min on masked tiles, the
    running max m in log2 units (c = scale * log2 e), the exps from base
    +inf while a row's max is at the masked level, the rescale 1 where m
    did not move; lse = (m + log2 l) * ln 2. q, k, v: [T, D]."""
    t, d = q.shape
    c = (1.0 / math.sqrt(d)) * math.log2(math.e)
    out, lse = np.zeros((t, d)), np.zeros(t)
    for _, walks in _row_walk(sid, nwg, bn):
        for first, tiles in walks:
            if first >= t:
                continue
            rows = slice(first, first + 64)
            m = np.full((64, 1), -np.inf)
            l, o = np.zeros((64, 1)), np.zeros((64, d))
            for j, kind in tiles:
                if kind == "skip":
                    continue
                cols = slice(j * bn, (j + 1) * bn)
                s = q[rows] @ k[cols].T
                if kind == "masked":
                    s = np.where(sid[cols][None, :] <= sid[rows][:, None], s,
                                 NEG)
                new = np.maximum(m, s.max(-1, keepdims=True) * c)
                with np.errstate(invalid="ignore"):
                    a = np.where(new == m, 1.0, np.exp2(m - new))
                base = np.where(new < NO_KEY_YET, np.inf, new)
                p = np.exp2(s * c - base)
                l = l * a + p.sum(-1, keepdims=True)
                o = o * a + p @ v[cols]
                m = new
            out[rows] = o / l
            lse[rows] = ((m + np.log2(l)) * math.log(2.0))[:, 0]
    return out, lse


@pytest.mark.parametrize("order,n,p,d", [
    ("sorted", 256, 16, 32), ("sorted", 384, 40, 64),
    ("shuffled", 384, 16, 32), ("shuffled", 256, 40, 64),
    ("first tile unseen", 256, 16, 32), ("first tile unseen", 384, 16, 64)])
def test_exp2_walk_matches_twin(order, n, p, d):
    """Float64 mirror against the twin at float64 (which rounds nothing),
    the first tile unseen by most rows included: no NaN, no leak."""
    h = 2
    sid = _slab_ids(order, n, p, seed=n + d)
    rng = np.random.default_rng(n * d)
    q, k, v = (rng.standard_normal((n, h, d)) for _ in range(3))
    nwg, bn = _shape("PosFwdOf", d)
    got = [_exp2_walk(q[:, i], k[:, i], v[:, i], sid, nwg, bn)
           for i in range(h)]
    fold = lambda x: torch.from_numpy(x).reshape(1, n, h * d)
    ref, ref_lse = k67.flash_attention_ref(
        fold(q), fold(k), fold(v), n_heads=h, mode="positions",
        slab_ids=torch.from_numpy(sid[None]))
    out = np.stack([g[0] for g in got], axis=1)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref.reshape(n, h, d).numpy(),
                               atol=FWD_TOL)
    np.testing.assert_allclose(np.stack([g[1] for g in got]),
                               ref_lse[0].numpy(), atol=FWD_TOL)


@pytest.mark.parametrize("n,p,d", [(256, 16, 32), (384, 40, 64)])
def test_exp2_walk_matches_gathered_kernel_interpret(n, p, d):
    """The mirror against the JAX package's gathered Pallas kernel in
    interpret mode, on sorted kept positions (the JAX kernel's contract)."""
    b, h = 1, 2
    rng = np.random.default_rng(7 * n + d)
    pos = np.sort(rng.choice(4 * n, size=n, replace=False)).astype(np.int32)
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32)
               for _ in range(3))
    want = block_attention.gathered_slab_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(pos[None]), p,
        interpret=True)
    nwg, bn = _shape("PosFwdOf", d)
    sid = pos // p
    got = np.stack([_exp2_walk(*(x[0, :, i].astype(np.float64)
                                 for x in (q, k, v)), sid, nwg, bn)[0]
                    for i in range(h)], axis=1)
    np.testing.assert_allclose(got, np.asarray(want)[0], atol=FWD_TOL)


@pytest.mark.parametrize("d", [32, 64])
def test_masked_score_breaks_one_fma_exp(d):
    """Why the softmax guards a row that has seen only masked scores: its
    max is fl(s * c) for s = finfo(f32).min, and one FFMA's s * c - max is
    s * c's rounding error, not 0: 2^(that) is 0 or inf, never the 1 the
    unguarded algebra assumes. (f32 products are exact in float64.)"""
    c = np.float32(np.float32(1.0 / math.sqrt(d)) * np.float32(math.log2(
        math.e)))
    s = np.float32(NEG)
    m = np.float32(s * c)
    residual = float(np.float64(s) * np.float64(c) - np.float64(m))
    assert m < NO_KEY_YET and abs(residual) > 2.0 ** 90


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _spellings(name: str) -> dict:
    """The forms a profiler may report a kernel's name in: the symbol, the
    demangled template instance (its shape struct) and the mangled one."""
    cfg = CONFIGS[name]
    return {"bare": name,
            "demangled": f"void (anonymous namespace)::{name}<(anonymous "
                         f"namespace)::{cfg}<32, 2, 64, 2> >(CUtensorMap_st, "
                         "CUtensorMap_st, CUtensorMap_st, int const*, "
                         "__nv_bfloat16*, float*, int, int, float)",
            "mangled": f"_ZN12_GLOBAL__N_1{len(name)}{name}INS_{len(cfg)}"
                       f"{cfg}ILi32ELi2ELi64ELi2EEEEEv14CUtensorMap_stS3_S3_"
                       "PKiP13__nv_bfloat16Pfiif"}


@pytest.mark.parametrize("form", ["bare", "demangled", "mangled"])
@pytest.mark.parametrize("name", k67.POSITIONS_KERNELS)
def test_k6_kernels_fall_in_their_profile_families(name, form):
    assert _chip_smoke()._family(_spellings(name)[form]) == FAMILIES[name]


def test_k6_kernels_are_the_sources_positions_kernels():
    kernels = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
        SOURCE.read_text())
    assert set(k67.POSITIONS_KERNELS) <= set(kernels)
    for name in k67.POSITIONS_KERNELS:
        assert "positions" in name and "dense" not in name
