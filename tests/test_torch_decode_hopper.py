"""K2's and K5's persistent Hopper step (``csrc/decode_common.cuh``) from
the CPU.

- The schedule, written out in Python with the constants read from the
  source (tile depth and width, cache-tile rows, consumer warps, the wgmma
  chunk widths): for grids of 132 * k CTAs every (layer, product, N chunk,
  output tile, depth split) and every attention item (batch row, KV head)
  is owned by exactly one CTA; the depth splits partition each product's
  depth in order (the fixed split-K order); the N chunks cover the batch
  rows once for B in {1, 8, 128, 160, 300}; the ring positions the producer
  warp fills are, in order, the ones the consumers wait for.
- A float64 mirror of the swapped product (out^T = W^T . h^T tile by tile,
  chunk by chunk, each depth split's partial summed in split order, then
  the w8 scale) equals the plain product; whole steps built on it (GPT-2
  and LLaMA, with the kernel's rounding points) agree with
  ``fused_decode_blocks_ref`` / ``fused_llama_decode_blocks_ref``.
- Both gates take every shape they took before the redesign.
- The kernels are named ``gpt2_decode_step`` / ``llama_decode_step`` and
  fall in ``chip_smoke.py``'s "K2" / "K5" profile families, ahead of
  cuBLAS's ``gemm`` and the reductions' ``norm``; the split-K launches and
  their finalize kernels are gone from the sources; each kernel compiles
  only its own model's paths (the model is a template parameter).

Inputs from numpy seeds."""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from frankenstein_tpu_torch.ops import rope
from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
from frankenstein_tpu_torch.ops.cuda import fused_llama_decode as k5

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "frankenstein_tpu_torch" / "csrc"
COMMON = (CSRC / "decode_common.cuh").read_text()
KERNEL_RE = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\("
MIRROR_TOL = 2e-2   # the twins' f32 against the f64 mirror, relative to
                    # max |twin|: the same bf16 roundings, other sum orders


def _const(name: str) -> int:
    found = re.search(rf"constexpr (?:int|unsigned) {name} = (\d+)", COMMON)
    assert found, name
    return int(found.group(1))


KT = _const("KT")
TILE_M = _const("TILE_M")
ATT_ROWS = _const("ATT_ROWS")
N_CHUNK_MAX = _const("N_CHUNK_MAX")
ACT = _const("ACT")
SLOT = _const("SLOT")
WARPS = _const("CONSUMERS") // 32
# the wgmma widths: the product switch's cases, its default N_CHUNK_MAX
WIDTHS = sorted({int(c) for c in re.findall(r"case (\d+): product_tile",
                                            COMMON)} | {N_CHUNK_MAX})


def chunk_width(rows: int) -> int:
    """``chunk_width``: the wgmma N of a chunk of ``rows`` batch rows, the
    smallest width that holds them padded to 8."""
    pad = (rows + 7) & ~7
    return next(w for w in WIDTHS if pad <= w)


def depth_splits(k: int, tiles: int, chunks: int, items: int) -> int:
    """``depth_splits``: the largest divisor of the K / KT stages that keeps
    tiles * chunks * splits within ``items``."""
    stages, want = k // KT, items // (tiles * chunks)
    return max(s for s in range(1, max(1, min(stages, want)) + 1)
               if stages % s == 0)


def products(model: str, e: int, f: int, e_kv: int) -> list:
    """(depth, output segments) of the four products of a layer."""
    if model == "gpt2":
        return [(e, [3 * e]), (e, [e]), (e, [4 * e]), (4 * e, [e])]
    return [(e, [e, e_kv, e_kv]), (e, [e]), (e, [f, f]), (f, [e])]


def fold_act(model, b, e, f, e_kv, items, n_chunk) -> bool:
    """``plan``'s choice: ACT folds GELU / SwiGLU into its epilogue when its
    folded items (a LLaMA gate|up item holds both tiles) fill at least half
    the item target."""
    lanes = sum(products(model, e, f, e_kv)[ACT][1])
    folded = lanes // TILE_M // (2 if model == "llama" else 1)
    return 2 * folded * -(-b // n_chunk) >= items


def plan(model, b, e, f, e_kv, items, n_chunk):
    """Each product's (K, tiles, splits, passes) as ``plan`` and
    ``tiles_of`` set them: a folded ACT takes its whole depth in one split,
    and LLaMA's folded gate|up tile t is the gate's and the up's lanes
    [64 t, 64 t + 64), two passes of one item; otherwise ACT splits like
    the others."""
    chunks = -(-b // n_chunk)
    fold = fold_act(model, b, e, f, e_kv, items, n_chunk)
    out = []
    for q, (k, segs) in enumerate(products(model, e, f, e_kv)):
        passes = 2 if model == "llama" and q == ACT and fold else 1
        tiles = sum(segs) // TILE_M // passes
        splits = 1 if q == ACT and fold else depth_splits(
            k, sum(segs) // TILE_M, chunks, items)
        out.append((k, tiles, splits, passes))
    return out


def product_items(b, n_chunk, tiles, splits):
    """Item i of a product -> (chunk, tile, split), split fastest."""
    chunks = -(-b // n_chunk)
    return [((i // (splits * tiles)), (i // splits) % tiles, i % splits)
            for i in range(chunks * tiles * splits)]


def attention_items(cta, g, items):
    """The attention items of a CTA: i = cta + k * G."""
    return list(range(cta, items, g))


MODELS = {"gpt2": dict(e=768, f=3072, e_kv=768, kv=12, s=64, d=64),
          "llama": dict(e=1024, f=2816, e_kv=512, kv=8, s=64, d=64),
          "llama_1b": dict(e=2048, f=5632, e_kv=1024, kv=8, s=48, d=128)}


@pytest.mark.parametrize("g", [132, 264, 396])
@pytest.mark.parametrize("b", [1, 8, 128, 160, 300])
@pytest.mark.parametrize("name", list(MODELS))
def test_every_item_has_one_owner(name, b, g):
    m = MODELS[name]
    model = "gpt2" if name == "gpt2" else "llama"
    n_layer = 2
    for n_chunk in (N_CHUNK_MAX, 32):
        pl = plan(model, b, m["e"], m["f"], m["e_kv"], 132, n_chunk)
        for q, (k, tiles, splits, _) in enumerate(pl):
            items = product_items(b, n_chunk, tiles, splits)
            owned = {}
            for l in range(n_layer):
                for cta in range(g):
                    for i in range(cta, len(items), g):
                        key = (l, q, *items[i])
                        assert key not in owned
                        owned[key] = cta
            chunks = -(-b // n_chunk)
            assert len(owned) == n_layer * chunks * tiles * splits
        att = b * m["kv"]
        seen = sorted(i for cta in range(g)
                      for i in attention_items(cta, g, att))
        assert seen == list(range(att))


def test_act_folds_at_beam_width_and_splits_at_small_batch():
    """The fc / gate|up product folds its activation where its items fill
    the grid (B*W=160) and splits its depth with an act phase where they
    would leave most CTAs idle (B=8, and the 1B-class width at B=8)."""
    for name, b, want in (("gpt2", 160, True), ("llama", 160, True),
                          ("gpt2", 8, False), ("llama", 32, False),
                          ("llama_1b", 8, False)):
        m = MODELS[name]
        model = "gpt2" if name == "gpt2" else "llama"
        assert fold_act(model, b, m["e"], m["f"], m["e_kv"], 264,
                        N_CHUNK_MAX) == want


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("b", [1, 8, 128, 160, 300])
def test_depth_splits_partition_each_product_in_order(name, b):
    m = MODELS[name]
    model = "gpt2" if name == "gpt2" else "llama"
    for items in (66, 132, 264, 528):
        for k, _, splits, _ in plan(model, b, m["e"], m["f"], m["e_kv"],
                                    items, N_CHUNK_MAX):
            kd = k // splits
            assert kd % KT == 0
            # split z's stages, taken in the order finalize sums them
            order = [z * kd + s * KT for z in range(splits)
                     for s in range(kd // KT)]
            assert order == list(range(0, k, KT))


@pytest.mark.parametrize("b", [1, 8, 128, 160, 300])
def test_n_chunks_cover_the_batch_once(b):
    for n_chunk in WIDTHS:
        rows = []
        for c in range(-(-b // n_chunk)):
            r = min(n_chunk, b - c * n_chunk)
            width = chunk_width(r)
            assert r <= width <= N_CHUNK_MAX and width % 8 == 0
            rows += range(c * n_chunk, c * n_chunk + r)
        assert rows == list(range(b))


def _walk(model, b, g, cta, length, ring, cache_bytes, n_chunk=N_CHUNK_MAX,
          items=132):
    """One layer of a CTA as the producer fills the ring and as the
    consumers wait on it: (the producer's fills in order, the consumers'
    waits as (position, what they expect there))."""
    m = MODELS[model]
    pl = plan("gpt2" if model == "gpt2" else "llama", b, m["e"], m["f"],
              m["e_kv"], items, n_chunk)
    nt = -(-length // ATT_ROWS)
    att = attention_items(cta, g, b * m["kv"])
    fills, waits, n = [], [], 0

    def product(q):
        nonlocal n
        k, tiles, splits, passes = pl[q]
        its = product_items(b, n_chunk, tiles, splits)
        for i in range(cta, len(its), g):
            for pss in range(passes):
                for s in range(k // splits // KT):
                    fills.append((("w", q, i, pss, s),))
                    waits.append((n, 0, ("w", q, i, pss, s)))
                    n += 1

    product(0)
    per = min(WARPS, SLOT // (ATT_ROWS * m["d"] * cache_bytes))
    for k0 in range(0, len(att), WARPS):
        nw = min(WARPS, len(att) - k0)
        slots = -(-nw // per)
        for side in (0, 1):
            for t in range(nt):
                for j in range(slots):
                    fills.append(tuple(("kv", side, att[k0 + w], t) for w in
                                       range(j * per, min(nw, j * per + per))))
            for t in range(nt):
                # warp w waits at n + w // per for piece w % per; the group
                # releases its slots together (layout keeps ring >= slots)
                assert slots <= ring
                for w in range(nw):
                    waits.append((n + w // per, w % per,
                                  ("kv", side, att[k0 + w], t)))
                n += slots
    for q in (1, 2, 3):
        product(q)
    return fills, waits


@pytest.mark.parametrize("model,b,length", [("gpt2", 1, 0),
                                            ("gpt2", 8, 33),
                                            ("gpt2", 128, 56),
                                            ("gpt2", 160, 33),
                                            ("gpt2", 300, 70),
                                            ("llama", 160, 46),
                                            ("llama_1b", 8, 40)])
def test_consumers_wait_where_the_producer_filled(model, b, length):
    for g in (132, 264):
        for cta in (0, 1, g // 2, g - 1):
            for cache_bytes in (1, 2):
                d = MODELS[model]["d"]
                per = min(WARPS, SLOT // (ATT_ROWS * d * cache_bytes))
                fills, waits = _walk(model, b, g, cta, length,
                                     -(-WARPS // per), cache_bytes)
                # every piece of every fill is waited for exactly once, at
                # its position
                assert sorted((pos, k) for pos, k, _ in waits) == sorted(
                    (pos, k) for pos, f in enumerate(fills)
                    for k in range(len(f)))
                for pos, k, what in waits:
                    assert fills[pos][k] == what


def _swapped_product(a, w, scale, b, n_chunk, items):
    """out = a @ w (times scale) as the kernel computes it, in float64:
    per (chunk, tile, split) item the tile's W^T (64 lanes x its depth
    slice) times the chunk's h^T (its rows padded to the wgmma width with
    zeros), the split partials of each output summed in split order."""
    k, n = w.shape
    splits = depth_splits(k, n // TILE_M, -(-b // n_chunk), items)
    part = np.zeros((splits, b, n))
    kd = k // splits
    for c, t, z in product_items(b, n_chunk, n // TILE_M, splits):
        r0, rows = c * n_chunk, min(n_chunk, b - c * n_chunk)
        h_t = np.zeros((kd, chunk_width(rows)))
        h_t[:, :rows] = a[r0:r0 + rows, z * kd:(z + 1) * kd].T
        w_t = w[z * kd:(z + 1) * kd, t * TILE_M:(t + 1) * TILE_M].T
        part[z, r0:r0 + rows, t * TILE_M:(t + 1) * TILE_M] = \
            (w_t @ h_t)[:, :rows].T
    out = np.zeros((b, n))
    for z in range(splits):
        out = out + part[z]
    return out if scale is None else out * scale


@pytest.mark.parametrize("b,k,n", [(1, 256, 192), (8, 768, 2304),
                                   (128, 512, 64), (160, 384, 128),
                                   (300, 256, 64)])
@pytest.mark.parametrize("w8", [False, True])
def test_swapped_product_mirror_is_the_product(b, k, n, w8):
    rng = np.random.default_rng(b + k + n)
    a = rng.standard_normal((b, k))
    w = (rng.integers(-127, 128, (k, n)).astype(np.float64) if w8
         else rng.standard_normal((k, n)))
    scale = rng.random((1, n)) / 127 if w8 else None
    want = a @ w * (1.0 if scale is None else scale)
    for items in (1, 132, 528):
        for n_chunk in (N_CHUNK_MAX, 32, 8):
            got = _swapped_product(a, w, scale, b, n_chunk, items)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def _bf(t):
    """Round to bf16, back to float64."""
    return torch.as_tensor(t).to(torch.bfloat16).double()


def _dot(a, st, key, l, b, scale_key):
    """A product of the mirror: bf16 operands, float64 sums."""
    w = st[key][l].double()
    s = st[scale_key][l].double().numpy() if scale_key in st else None
    return torch.from_numpy(_swapped_product(
        _bf(a).numpy(), w.numpy(), s, b, N_CHUNK_MAX, 132))


def _k2_mirror(x, st, kc, vc, length, n_head):
    """One GPT-2 step as the kernel computes it, in float64."""
    b, e = x.shape
    d = e // n_head
    att_scale = 1.0 / math.sqrt(d)
    xf = x.double()
    vec = lambda key, l: st[key][l].double()

    def ln(v, w, bias):
        mu = v.mean(-1, keepdim=True)
        var = ((v - mu) ** 2).mean(-1, keepdim=True)
        return (v - mu) / torch.sqrt(var + 1e-5) * w + bias

    for l in range(st["qkv_w"].shape[0]):
        h = ln(xf, vec("ln1_w", l), vec("ln1_b", l))
        qkv = _dot(h, st, "qkv_w", l, b, "qkv_s") + vec("qkv_b", l)
        q, kn, vn = qkv.split(e, -1)
        o = torch.zeros(b, e, dtype=torch.float64)
        for hd in range(n_head):
            cols = slice(hd * d, (hd + 1) * d)
            qc = _bf(q[:, cols])
            s = torch.einsum("bd,bjd->bj", qc,
                             kc[l, :, :length, cols].double()) * att_scale
            s_own = (q[:, cols] * kn[:, cols]).sum(-1) * att_scale
            mx = torch.maximum(s.amax(-1), s_own) if length else s_own
            p = torch.exp(s - mx[:, None])
            p_own = torch.exp(s_own - mx)
            den = p.sum(-1) + p_own
            pr = _bf(p / den[:, None])
            o[:, cols] = torch.einsum("bj,bjd->bd", pr,
                                      vc[l, :, :length, cols].double()) \
                + (p_own / den)[:, None] * vn[:, cols]
        xf = (xf + _dot(o, st, "proj_w", l, b, "proj_s")) + vec("proj_b", l)
        h = ln(xf, vec("ln2_w", l), vec("ln2_b", l))
        z = _dot(h, st, "fc_w", l, b, "fc_s") + vec("fc_b", l)
        act = 0.5 * z * (1 + torch.erf(z / math.sqrt(2.0)))
        xf = (xf + _dot(act, st, "fc2_w", l, b, "fc2_s")) + vec("fc2_b", l)
    return xf


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("b,length", [(8, 5), (13, 0)])
def test_k2_step_mirror_agrees_with_the_twin(w8, b, length):
    n_layer, e, h, s = 2, 256, 4, 16
    rng = np.random.default_rng(b * 10 + length)
    rnd = lambda *shape, sc=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * sc).astype(np.float32))
    st = {key: rnd(n_layer, n, sc=0.05) for key, n in (
        ("ln1_w", e), ("ln1_b", e), ("qkv_b", 3 * e), ("proj_b", e),
        ("ln2_w", e), ("ln2_b", e), ("fc_b", 4 * e), ("fc2_b", e))}
    st["ln1_w"] += 1.0
    st["ln2_w"] += 1.0
    for key, shape in (("qkv_w", (e, 3 * e)), ("proj_w", (e, e)),
                       ("fc_w", (e, 4 * e)), ("fc2_w", (4 * e, e))):
        st[key] = rnd(n_layer, *shape, sc=0.05).to(torch.bfloat16)
    if w8:
        st = k2.quantize_weights(st)
    kc = rnd(n_layer, b, s, e).to(torch.bfloat16)
    vc = rnd(n_layer, b, s, e).to(torch.bfloat16)
    x = rnd(b, e).to(torch.bfloat16)
    want, _, _ = k2.fused_decode_blocks_ref(x, st, kc.clone(), vc.clone(),
                                            length, n_head=h)
    got = _k2_mirror(x, st, kc, vc, length, h)
    scale = float(want.float().abs().max())
    assert float((got - want.double()).abs().max()) <= MIRROR_TOL * scale


def _k5_mirror(x, st, kc, vc, length, cos, sin, n_heads, n_kv, eps):
    """One LLaMA step as the kernel computes it, in float64."""
    b, e = x.shape
    d, r = e // n_heads, n_heads // n_kv
    att_scale = 1.0 / math.sqrt(d)
    cos, sin = cos.double()[0], sin.double()[0]

    def rot(v, c, s_):
        pairs = v.unflatten(-1, (-1, 2))
        sw = torch.stack([-pairs[..., 1], pairs[..., 0]], -1).flatten(-2)
        return v * c + sw * s_

    def rms(v, w):
        return v / torch.sqrt((v * v).mean(-1, keepdim=True) + eps) * w

    xf = x.double()
    e_kv = n_kv * d
    for l in range(st["wq"].shape[0]):
        h = rms(xf, st["norm1_w"][l].double())
        q = rot(_dot(h, st, "wq", l, b, "wq_s"), cos, sin)
        kn = rot(_dot(h, st, "wk", l, b, "wk_s"), cos[:e_kv], sin[:e_kv])
        vn = _dot(h, st, "wv", l, b, "wv_s")
        o = torch.zeros(b, e, dtype=torch.float64)
        for hd in range(n_heads):
            g = hd // r
            qs, ks_ = slice(hd * d, (hd + 1) * d), slice(g * d, (g + 1) * d)
            qc = _bf(q[:, qs])
            s = _bf(qc[:, None, :] * kc[l, :, :length, ks_].double()) \
                .sum(-1) * att_scale
            s_own = (q[:, qs] * kn[:, ks_]).sum(-1) * att_scale
            mx = torch.maximum(s.amax(-1), s_own) if length else s_own
            p = torch.exp(s - mx[:, None])
            p_own = torch.exp(s_own - mx)
            den = p.sum(-1) + p_own
            pr = _bf(p / den[:, None])
            o[:, qs] = torch.einsum("bj,bjd->bd", pr,
                                    vc[l, :, :length, ks_].double()) \
                + (p_own / den)[:, None] * vn[:, ks_]
        xf = xf + _dot(o, st, "wo", l, b, "wo_s")
        h = rms(xf, st["norm2_w"][l].double())
        gt = _dot(h, st, "wg", l, b, "wg_s")
        up = _dot(h, st, "wu", l, b, "wu_s")
        xf = xf + _dot(gt * torch.sigmoid(gt) * up, st, "wd", l, b, "wd_s")
    return xf


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("b,length,h,kv", [(8, 5, 4, 2), (3, 0, 4, 4)])
def test_k5_step_mirror_agrees_with_the_twin(w8, b, length, h, kv):
    n_layers, e, f, s = 2, 256, 256, 16
    d = e // h
    rng = np.random.default_rng(b * 10 + length + kv)
    rnd = lambda *shape, sc=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * sc).astype(np.float32))
    st = {key: 1.0 + rnd(n_layers, e, sc=0.1) for key in ("norm1_w",
                                                          "norm2_w")}
    for key, shape in (("wq", (e, e)), ("wk", (e, kv * d)),
                       ("wv", (e, kv * d)), ("wo", (e, e)), ("wg", (e, f)),
                       ("wu", (e, f)), ("wd", (f, e))):
        st[key] = rnd(n_layers, *shape, sc=0.05).to(torch.bfloat16)
    if w8:
        st = k5.quantize_weights(st)
    kc = rnd(n_layers, b, s, kv * d).to(torch.bfloat16)
    vc = rnd(n_layers, b, s, kv * d).to(torch.bfloat16)
    x = rnd(b, e).to(torch.bfloat16)
    cos_e, sin_e = rope.folded_tables(rope.build_rope_cache(d, s), h)
    cos, sin = cos_e[length:length + 1], sin_e[length:length + 1]
    want, _, _ = k5.fused_llama_decode_blocks_ref(
        x, st, kc.clone(), vc.clone(), length, cos, sin, n_heads=h,
        n_kv_heads=kv, eps=1e-5)
    got = _k5_mirror(x, st, kc, vc, length, cos, sin, h, kv, 1e-5)
    scale = float(want.float().abs().max())
    assert float((got - want.double()).abs().max()) <= MIRROR_TOL * scale


def _old_k5_smem(d, r, s, cache_bytes):
    """The K5 gate's count before the persistent redesign (the split-K
    kernels' ``llama_attention_smem_bytes``)."""
    return ((3 * r * d + 2 * d + r * s + 2 * r + 3) & ~3) * 4 \
        + 64 * d * cache_bytes


def test_gates_take_every_shape_they_took():
    bf16, i8 = torch.bfloat16, torch.int8
    for e, n_head in ((768, 12), (1024, 16), (128, 2), (256, 4), (512, 8),
                      (1024, 8), (2048, 16), (256, 32), (1536, 12)):
        d = e // n_head
        for w in (bf16, i8):
            assert k2.supported("cuda", bf16, w, bf16, e, n_head)
            assert k2.supported("cuda", bf16, w, i8, e, n_head) == \
                (d % 16 == 0)
    shapes = [(1024, 16, 8, 2816, 64), (2048, 16, 8, 5632, 48),
              (256, 4, 2, 256, 48), (512, 4, 1, 256, 48),
              (128, 4, 2, 256, 48), (256, 32, 16, 256, 16),
              (1024, 16, 1, 2816, 1000)]
    for d, r, cb in ((64, 2, 1), (128, 4, 2), (32, 1, 1)):
        # the longest cache the earlier count took, and one row more
        s_max = max(s for s in range(1, 60000)
                    if _old_k5_smem(d, r, s, cb) <= 227 * 1024)
        kv = 4
        e = kv * r * d
        dtype = i8 if cb == 1 else bf16
        assert k5.supported("cuda", bf16, bf16, dtype, e, kv * r, kv, 256,
                            s_max)
        assert not k5.supported("cuda", bf16, bf16, dtype, e, kv * r, kv,
                                256, s_max + 8)
        assert k5.attention_smem_bytes(d, r, s_max, cb) == \
            _old_k5_smem(d, r, s_max, cb)
    for e, h, kv, f, s in shapes:
        for w in (bf16, i8):
            assert k5.supported("cuda", bf16, w, bf16, e, h, kv, f, s)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


INSTANCES = [("gpt2_decode_step", "K2", "signed char, signed char", "aa"),
             ("gpt2_decode_step", "K2", "__nv_bfloat16, signed char",
              "13__nv_bfloat16a"),
             ("llama_decode_step", "K5", "signed char, __nv_bfloat16",
              "a13__nv_bfloat16"),
             ("llama_decode_step", "K5", "__nv_bfloat16, __nv_bfloat16",
              "13__nv_bfloat16S0_")]


@pytest.mark.parametrize("name,family,targs,mangled", INSTANCES)
def test_decode_kernels_fall_in_their_families(name, family, targs,
                                               mangled):
    smoke = _chip_smoke()
    spellings = [name, f"void {name}<{targs}>(fk::decode::Params, "
                       f"fk::decode::Maps)",
                 f"_Z{len(name)}{name}I{mangled}EvN2fk6decode6ParamsENS2_"
                 f"4MapsE"]
    for key in spellings:
        assert smoke._family(key) == family
    order = [f for f, _ in smoke.PROFILE_FAMILIES]
    assert order.index(family) < order.index("cuBLAS")
    assert order.index(family) < order.index("reductions")


def test_the_split_k_launches_are_gone():
    for src, want in (("fused_decode.cu", ["gpt2_decode_step"]),
                      ("fused_llama_decode.cu", ["llama_decode_step"])):
        assert re.findall(KERNEL_RE, (CSRC / src).read_text()) == want
    for path in CSRC.glob("*.cu*"):
        text = path.read_text()
        for gone in ("gemm_partial", "gemm_segs", "splits_for",
                     "residual_rows", "gelu_rows", "start_rows",
                     "swiglu_rows"):
            assert gone not in text, (path.name, gone)


@pytest.mark.parametrize("src,llama", [("fused_decode.cu", "false"),
                                       ("fused_llama_decode.cu", "true")])
def test_each_kernel_compiles_only_its_model(src, llama):
    """The step's device code takes the model as the template parameter
    LLAMA, fixed by each kernel, so GPT-2's kernel holds none of LLaMA's
    paths (RoPE, SwiGLU, gate|up passes) and K5 none of GPT-2's: only the
    host's ``plan`` reads ``Params::llama``."""
    text = (CSRC / src).read_text()
    assert re.findall(r"decode_body<WT, CT, (\w+)>", text) == [llama]
    uses = [line for line in COMMON.splitlines()
            if re.search(r"\bp\.llama\b|p\.cos != nullptr", line)]
    assert len(uses) == 1 and "folded" in uses[0], uses
