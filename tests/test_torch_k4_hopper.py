"""K4's Hopper design (``csrc/slab_rope_attention_bwd.cu``) from the CPU.

- The pre-pass twin (``slab_attention.slab_rope_bwd_prep_ref``) rotates q
  and k bitwise as the JAX package's ``rope.apply_rope_folded`` does on the
  same bf16 inputs (the rotation K4's pre-pass shares with K1, so the
  recomputed scores are K1's), and its delta is a float64 rowsum's within
  1e-6 of its largest value (f32 sums in another order).
- Every kernel of the source falls in ``chip_smoke.py``'s "K4" profile
  family in the spellings a profiler may report, never in K6 / K7's.
- The Hopper blocks live once, in ``csrc/hopper_blocks.cuh``, which K7
  dense's source, K4's and K1's include.
- The slab-causal tile schedule of the dq and dk/dv passes, written out in
  Python as the kernels compute it (key / query tile ranges a consumer
  warpgroup walks, the tiles it waits for and releases, the tiles it masks
  per element), covers every visible pair and no other, and in the
  unmasked instance (P a multiple of 64) masks nothing.

Inputs from numpy seeds."""

import importlib.util
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
CSRC = ROOT / "frankenstein_tpu_torch" / "csrc"
SOURCE = CSRC / "slab_rope_attention_bwd.cu"
KERNELS = tuple(f"slab_rope_attn_bwd_{p}" for p in slab_attention.BWD_PASSES)
KERNEL_RE = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\("
BN = 64          # key tile (dq) and query tile (dk/dv) of both passes
DELTA_TOL = 1e-6


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("d", [32, 64])
def test_prep_twin_matches_jax_rope_and_rowsum(d):
    b, t, h = 2, 256, 3
    rng = np.random.default_rng(d)
    q, k, out, dout = (rng.standard_normal((b, t, h * d)).astype(np.float32)
                       for _ in range(4))
    cache = jrope.build_rope_cache(d, t)
    cos, sin = trope.folded_tables(torch.tensor(np.asarray(cache)), 1)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    qr, kr, delta = slab_attention.slab_rope_bwd_prep_ref(
        bf(q), bf(k), cos, sin, bf(out), bf(dout), n_heads=h)
    cos_e, sin_e = (jnp.asarray(x.repeat(1, h).numpy()) for x in (cos, sin))
    for name, x, got in (("q", q, qr), ("k", k, kr)):
        want = jrope.apply_rope_folded(jnp.asarray(x).astype(jnp.bfloat16),
                                       cos_e, sin_e)
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            err_msg=name)
    o64, d64 = (bf(x).double().numpy() for x in (out, dout))
    rowsum = (o64 * d64).reshape(b, t, h, d).sum(-1).transpose(0, 2, 1)
    assert delta.shape == (b, h, t) and delta.dtype == torch.float32
    err = np.abs(delta.double().numpy() - rowsum).max()
    assert err <= DELTA_TOL * np.abs(rowsum).max()


def _spellings(name: str) -> dict:
    """The symbol, the demangled template instance and the mangled one, as
    nvcc names the D = 32 instances."""
    mangled_head = (f"_ZN59_GLOBAL__N__ffe438e1_26_slab_rope_attention_bwd_"
                    f"cu_38736880{len(name)}{name}")
    if name.endswith("_prep"):
        return {"bare": name,
                "demangled": f"void (anonymous namespace)::{name}<32>("
                             "__nv_bfloat16 const*, __nv_bfloat16 const*, "
                             "float const*, float const*, __nv_bfloat16 "
                             "const*, __nv_bfloat16 const*, __nv_bfloat16*, "
                             "__nv_bfloat16*, float*, int, int, unsigned "
                             "long)",
                "mangled": f"{mangled_head}ILi32EEEvPK13__nv_bfloat16S3_PKf"
                           "S5_S3_S3_PS1_S6_Pfiim"}
    dq = name.endswith("_dq")
    cfg = "DqPass" if dq else "DkvPass"
    return {"bare": name,
            "demangled": f"void (anonymous namespace)::{name}<(anonymous "
                         f"namespace)::{cfg}<32, 3, 64, 1, false> >("
                         "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                         "CUtensorMap_st, float const*, float const*, float "
                         "const*, float const*, __nv_bfloat16*, "
                         f"{'' if dq else '__nv_bfloat16*, '}int, int, int, "
                         "float)",
            "mangled": f"{mangled_head}INS_{len(cfg)}{cfg}ILi32ELi3ELi64ELi1"
                       "ELb0EEEEEv14CUtensorMap_stS3_S3_S3_PKfS5_S5_S5_P13__"
                       f"nv_bfloat16{'' if dq else 'S7_'}iiif"}


@pytest.mark.parametrize("form", ["bare", "demangled", "mangled"])
@pytest.mark.parametrize("name", KERNELS)
def test_k4_kernels_fall_in_the_k4_family(name, form):
    family = _chip_smoke()._family(_spellings(name)[form])
    assert family == "K4"
    assert not family.startswith(("K6 bwd", "K7 bwd"))


def test_k4_kernel_names_are_the_sources_kernels():
    kernels = re.findall(KERNEL_RE, SOURCE.read_text())
    assert sorted(kernels) == sorted(KERNELS)
    for name in kernels:
        assert "slab_rope_attn_bwd" in name and "flash_attn_bwd" not in name


def test_hopper_blocks_live_once_in_the_shared_header():
    header = (CSRC / "hopper_blocks.cuh").read_text()
    assert not re.findall(KERNEL_RE, header)
    users = [CSRC / "flash_attention_dense.cu", SOURCE,
             CSRC / "slab_rope_attention_fwd.cu",
             CSRC / "slab_rope_attention_int8.cu", CSRC / "fused_mlp.cu"]
    for src in users:
        assert '#include "hopper_blocks.cuh"' in src.read_text(), src.name
    for helper in ("mbar_wait", "tma_load", "smem_desc", "to_a", "tile_map",
                   "aligned_smem", "online_softmax", "key_end", "pass_tile",
                   "kmajor_desc", "tile_map_rows", "fence_regs"):
        defined = [p.name for p in sorted(CSRC.glob("*.cu*"))
                   if re.search(rf"\b{helper}\([^;]*\)\s*{{", p.read_text())]
        assert defined == ["hopper_blocks.cuh"], (helper, defined)


# The passes' schedule as the kernels compute it (slab_rope_attention_bwd.cu)

def _key_end(row, t, p):
    return min(t, (row // p + 1) * p)


def _visible(q, k, p):
    return k // p <= q // p


def _dq_schedule(t, p, nwg):
    """Per (CTA, warpgroup): (first row, tiles the producer streams, tiles
    walked, tiles released unseen, tiles masked per element), as
    slab_rope_attn_bwd_dq has them."""
    bm = 64 * nwg
    for q0 in range(0, t, bm):
        nk = -(-_key_end(min(q0 + bm, t) - 1, t, p) // BN)
        for cw in range(nwg):
            first = q0 + 64 * cw
            nkw = -(-_key_end(first + 63, t, p) // BN) if first < t else 0
            mask_from = (first // p + 1) * p
            masked = {j for j in range(nkw) if (j + 1) * BN > mask_from}
            yield first, range(nk), range(nkw), range(nkw, nk), masked


def _dkv_schedule(t, p, nwg):
    """Per (CTA, warpgroup): (first key, tiles the producer streams, tiles
    walked, tiles released unseen, tiles masked per element), as
    slab_rope_attn_bwd_dkv has them."""
    bm, nq = 64 * nwg, t // BN
    for j0 in range(0, t, bm):
        i0 = (j0 // p) * p // BN
        for cw in range(nwg):
            first = j0 + 64 * cw
            iw = (first // p) * p // BN if first < t else nq
            mask_below = ((first + 63) // p) * p
            masked = {i for i in range(iw, nq) if i * BN < mask_below}
            yield (first, range(i0, nq), range(iw, nq),
                   range(i0, min(iw, nq)), masked)


SCHEDULES = [(t, p, nwg) for t, p in [(768, 256), (640, 64), (512, 8),
                                      (384, 96), (256, 256), (512, 512),
                                      (384, 100), (256, 1000)]
             for nwg in (2, 3)]


@pytest.mark.parametrize("t,p,nwg", SCHEDULES)
def test_dq_schedule_covers_the_visible_keys(t, p, nwg):
    for first, streamed, walked, released, masked in _dq_schedule(t, p, nwg):
        rows = range(first, min(first + 64, t))
        for j in range(-(-t // BN)):
            keys = range(j * BN, (j + 1) * BN)
            seen = {(q, k) for q in rows for k in keys if _visible(q, k, p)}
            if j in walked:
                assert seen, (first, j)
                if j not in masked:      # wholly visible: no mask code
                    assert len(seen) == len(rows) * BN, (first, j)
            else:
                assert not seen, (first, j)
        # every tile the producer streams is walked or released, once
        assert not (set(walked) & set(released))
        assert set(walked) | set(released) == set(streamed), first
        if p % 64 == 0:
            assert not masked, (first, sorted(masked))


@pytest.mark.parametrize("t,p,nwg", SCHEDULES)
def test_dkv_schedule_covers_the_visible_queries(t, p, nwg):
    for first, streamed, walked, released, masked in _dkv_schedule(t, p, nwg):
        keys = range(first, min(first + 64, t))
        for i in range(t // BN):
            rows = range(i * BN, (i + 1) * BN)
            seen = {(q, k) for q in rows for k in keys if _visible(q, k, p)}
            if i in walked:
                assert seen, (first, i)
                if i not in masked:
                    assert len(seen) == len(keys) * BN, (first, i)
            else:
                assert not seen, (first, i)
        # every tile the producer streams is walked or released, once
        assert not (set(walked) & set(released))
        assert set(walked) | set(released) == set(streamed), first
        if p % 64 == 0:
            assert not masked, (first, sorted(masked))
