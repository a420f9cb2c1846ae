"""K1's Hopper design (``csrc/slab_rope_attention_fwd.cu``) from the CPU.

- The forward pre-pass's twin (``slab_attention.slab_rope_fwd_prep_ref``)
  rotates q and k bitwise as the JAX package's ``rope.apply_rope_folded``
  does on the same bf16 inputs (the rotation K4's pre-pass shares, so K4
  recomputes K1's scores).
- Every kernel of the source is named ``slab_rope_attn_fwd_*`` and falls in
  ``chip_smoke.py``'s "K1" profile family in the spellings a profiler may
  report, never in K6 / K7's forward.
- The forward's slab-causal tile schedule, written out in Python as the
  kernel computes it (the key tiles the producer streams for a CTA, the
  tiles each consumer warpgroup walks, waits for and releases, the tiles
  it masks per element), walks every visible (query, key) pair once and
  no invisible tile, releases every streamed tile once in each warpgroup,
  and in the unmasked instance masks nothing.
- A float64 mirror of the forward's log2-unit online softmax (tile by
  tile, the invisible keys of a masked tile at -inf, lse = (m + log2 l) *
  ln 2) gives the twin's lse and out.

Inputs from numpy seeds."""

import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.ops import rope as jrope
from frankenstein_tpu_torch.ops import rope as trope
from frankenstein_tpu_torch.ops.cuda import slab_attention

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "frankenstein_tpu_torch" / "csrc" / "slab_rope_attention_fwd.cu"
KERNELS = ("slab_rope_attn_fwd_prep", "slab_rope_attn_fwd_wgmma")
KERNEL_RE = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\("
# the forward's shapes as FwdOf has them: head_dim -> (consumer
# warpgroups, key tile)
SHAPES = {32: (2, 64), 64: (3, 64)}
MIRROR_TOL = 1e-6


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("d", [32, 64])
def test_prep_twin_rotates_as_jax_rope(d):
    b, t, h = 2, 256, 3
    rng = np.random.default_rng(d + 1)
    q, k = (rng.standard_normal((b, t, h * d)).astype(np.float32)
            for _ in range(2))
    cache = jrope.build_rope_cache(d, t)
    cos, sin = trope.folded_tables(torch.tensor(np.asarray(cache)), 1)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    qr, kr = slab_attention.slab_rope_fwd_prep_ref(bf(q), bf(k), cos, sin,
                                                   n_heads=h)
    cos_e, sin_e = (jnp.asarray(x.repeat(1, h).numpy()) for x in (cos, sin))
    for name, x, got in (("q", q, qr), ("k", k, kr)):
        want = jrope.apply_rope_folded(jnp.asarray(x).astype(jnp.bfloat16),
                                       cos_e, sin_e)
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            err_msg=name)


def test_mirror_shapes_are_the_sources():
    found = re.search(r"using FwdOf = FwdPass<D, D == 32 \? (\d+) : (\d+), "
                      r"(\d+),", SOURCE.read_text())
    assert found, "FwdOf's line changed: update SHAPES"
    nwg32, nwg64, bn = map(int, found.groups())
    assert SHAPES == {32: (nwg32, bn), 64: (nwg64, bn)}


def _spellings(name: str) -> dict:
    """The symbol, the demangled template instance and the mangled one, as
    nvcc names the D = 32 instances."""
    anon = "_GLOBAL__N__ffe438e1_26_slab_rope_attention_fwd_cu_38736880"
    head = f"_ZN{len(anon)}{anon}{len(name)}{name}"
    if name.endswith("_prep"):
        return {"bare": name,
                "demangled": f"void (anonymous namespace)::{name}<32>("
                             "__nv_bfloat16 const*, __nv_bfloat16 const*, "
                             "float const*, float const*, __nv_bfloat16*, "
                             "__nv_bfloat16*, int, int, unsigned long)",
                "mangled": f"{head}ILi32EEEvPK13__nv_bfloat16S3_PKfS5_PS1_"
                           "S6_iim"}
    return {"bare": name,
            "demangled": f"void (anonymous namespace)::{name}<(anonymous "
                         "namespace)::FwdPass<32, 2, 64, 2, false, 0> >("
                         "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                         "__nv_bfloat16*, float*, int, int, int, float)",
            "mangled": f"{head}INS_7FwdPassILi32ELi2ELi64ELi2ELb0ELi0EEEEEv14"
                       "CUtensorMap_stS3_S3_P13__nv_bfloat16Pfiiif"}


@pytest.mark.parametrize("form", ["bare", "demangled", "mangled"])
@pytest.mark.parametrize("name", KERNELS)
def test_k1_kernels_fall_in_the_k1_family(name, form):
    family = _chip_smoke()._family(_spellings(name)[form])
    assert family == "K1"
    assert family not in ("K6 fwd", "K7 fwd")


def test_k1_kernel_names_are_the_sources_kernels():
    text = SOURCE.read_text()
    kernels = re.findall(KERNEL_RE, text)
    assert sorted(kernels) == sorted(KERNELS)
    for name in kernels:
        assert name.startswith("slab_rope_attn_fwd_")
        assert "flash_attn_fwd" not in name
    assert "flash_attn_fwd" not in text.split("#include")[-1]


# The forward's schedule as the kernel computes it (slab_rope_attn_fwd_wgmma)

def _key_end(row, t, p):
    return min(t, (row // p + 1) * p)


def _unmasked(p, bn):
    return p % bn == 0 and p % 64 == 0


def _fwd_schedule(t, p, nwg, bn):
    """Per (CTA, warpgroup): (first row, tiles the producer streams, tiles
    walked, tiles released unseen, tiles masked per element), as
    slab_rope_attn_fwd_wgmma has them; the CTAs heaviest first."""
    bm = 64 * nwg
    for q0 in reversed(range(0, t, bm)):
        nk = -(-_key_end(min(q0 + bm, t) - 1, t, p) // bn)
        for cw in range(nwg):
            first = q0 + 64 * cw
            nkw = -(-_key_end(first + 63, t, p) // bn) if first < t else 0
            mask_from = (first // p + 1) * p
            masked = {j for j in range(nkw) if (j + 1) * bn > mask_from}
            yield first, range(nk), range(nkw), range(nkw, nk), masked


@pytest.mark.parametrize("p", [8, 64, 96, 100, 192, 256, None])
@pytest.mark.parametrize("t", [256, 640, 6144])
@pytest.mark.parametrize("d", sorted(SHAPES))
def test_fwd_schedule_covers_the_visible_keys(d, t, p):
    p = p or t
    nwg, bn = SHAPES[d]
    n_tiles = -(-t // bn)
    starts = np.arange(n_tiles) * bn
    rows_seen, pairs = 0, 0
    for first, streamed, walked, released, masked in _fwd_schedule(
            t, p, nwg, bn):
        rows = np.arange(first, min(first + 64, t))
        rows_seen += len(rows)
        ends = np.minimum(t, (rows // p + 1) * p)
        # visible keys of each (row, tile): [row, tile]
        seen = np.clip(ends[:, None] - starts[None, :], 0, bn)
        for j in range(n_tiles):
            if j in walked:
                assert seen[:, j].sum() > 0, (first, j)
                if j not in masked:      # wholly visible: no mask code
                    assert seen[:, j].sum() == len(rows) * bn, (first, j)
            else:
                assert seen[:, j].sum() == 0, (first, j)
        pairs += int(seen[:, list(walked)].sum()) if len(walked) else 0
        # every tile the producer streams is walked or released, once
        assert not (set(walked) & set(released))
        assert set(walked) | set(released) == set(streamed), first
        assert len(walked) + len(released) == len(streamed)
        if _unmasked(p, bn):
            assert not masked, (first, sorted(masked))
    # each row in one warpgroup, each visible pair in one walked tile
    assert rows_seen == t
    assert pairs == sum(_key_end(i, t, p) for i in range(t))


def _online_softmax_mirror(qr, kr, v, t, p, nwg, bn, scale):
    """The forward's arithmetic in float64 on one head: [T, D] rotated q,
    k and v -> (out [T, D], lse [T]), tile by tile over the tiles each
    warpgroup walks, the invisible keys of a masked tile at -inf, the
    running max in log2 units, lse = (m + log2 l) * ln 2."""
    c = scale * math.log2(math.e)
    out, lse = np.zeros_like(qr), np.zeros(t)
    for first, _, walked, _, masked in _fwd_schedule(t, p, nwg, bn):
        rows = np.arange(first, min(first + 64, t))
        ends = np.minimum(t, (rows // p + 1) * p)
        m = np.full(len(rows), -np.inf)
        l, o = np.zeros(len(rows)), np.zeros((len(rows), qr.shape[1]))
        for j in walked:
            keys = np.arange(j * bn, (j + 1) * bn)
            s = qr[rows] @ kr[keys].T
            if j in masked:
                s = np.where(keys[None, :] >= ends[:, None], -np.inf, s)
            n = np.maximum(m, s.max(axis=1) * c)
            a = np.where(n == m, 1.0, np.exp2(m - n))
            e = np.exp2(s * c - n[:, None])
            l, o, m = l * a + e.sum(axis=1), o * a[:, None] + e @ v[keys], n
        out[rows], lse[rows] = o / l[:, None], (m + np.log2(l)) * math.log(2)
    return out, lse


@pytest.mark.parametrize("p", [8, 64, 96, 192, 256])
@pytest.mark.parametrize("d", sorted(SHAPES))
def test_online_softmax_mirror_matches_the_twin(d, p):
    b, t, h = 1, 384, 2
    nwg, bn = SHAPES[d]
    rng = np.random.default_rng(d * 1000 + p)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h * d)))
               for _ in range(3))
    cos, sin = trope.folded_tables(
        trope.build_rope_cache(d, t).to(torch.float64), 1)
    out, lse = slab_attention.slab_rope_attention_ref(
        q, k, v, cos, sin, n_heads=h, tok_per_time=p)
    qr, kr = slab_attention.slab_rope_fwd_prep_ref(q, k, cos, sin, n_heads=h)
    for head in range(h):
        cols = slice(head * d, (head + 1) * d)
        got_out, got_lse = _online_softmax_mirror(
            qr[0, :, cols].numpy(), kr[0, :, cols].numpy(),
            v[0, :, cols].numpy(), t, p, nwg, bn, 1.0 / math.sqrt(d))
        want_lse = lse[0, head].numpy()
        assert np.abs(got_lse - want_lse).max() <= MIRROR_TOL
        assert np.abs(got_out - out[0, :, cols].numpy()).max() <= MIRROR_TOL
