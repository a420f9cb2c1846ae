"""K7 dense's wgmma kernels (``csrc/flash_attention_dense.cu``) from the
CPU: their symbol names, as ``ops/cuda/flash_attention.py`` keeps them, are
the source's kernels (with K6's, which share the source) and fall in
``chip_smoke.py``'s K7 profile families (never "cuBLAS" or K6's); and the kernels' softmax arithmetic, written
out in plain PyTorch (log2 units, one FFMA and ex2 a score, the rescale
skipped where a row's max does not move, lse = (m + log2 l) * ln 2),
matches the JAX package's dense Pallas kernel in interpret mode at the
shapes the card tests use. float32, inputs from numpy seeds; tolerance
3e-5, that of ``tests/test_attention.py``."""

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
KEY_TILE = 64    # the D = 32 forward's keys a tile (FwdOf<32>::BN)
FAMILIES = dict(zip(k67.DENSE_KERNELS,
                    ("K7 fwd", "K7 bwd dq", "K7 bwd dk/dv")))
CONFIGS = dict(zip(k67.DENSE_KERNELS, ("Fwd", "Dq", "Dkv")))  # template args


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _spellings(name: str) -> dict:
    """The forms a profiler may report a kernel's name in: the symbol, the
    demangled template instance (its config struct) and the mangled one."""
    cfg = CONFIGS[name]
    return {"bare": name,
            "demangled": f"void (anonymous namespace)::{name}<(anonymous "
                         f"namespace)::{cfg}<32, 2, 64, 2> >(CUtensorMap_st, "
                         "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, "
                         "float*, int, int, float)",
            "mangled": f"_ZN12_GLOBAL__N_1{len(name)}{name}INS_{len(cfg)}"
                       f"{cfg}ILi32ELi2ELi64ELi2EEEEEv14CUtensorMap_stS3_S3_"
                       "P13__nv_bfloat16Pfiif"}


@pytest.mark.parametrize("form", ["bare", "demangled", "mangled"])
@pytest.mark.parametrize("name", k67.DENSE_KERNELS)
def test_dense_kernels_fall_in_their_profile_families(name, form):
    assert _chip_smoke()._family(_spellings(name)[form]) == FAMILIES[name]


def test_dense_kernel_names_are_the_sources_kernels():
    kernels = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
        SOURCE.read_text())
    assert sorted(kernels) == sorted(k67.DENSE_KERNELS
                                     + k67.POSITIONS_KERNELS
                                     + k67.SLAB_KERNELS)


def _exp2_attention(q, k, v, tile: int = KEY_TILE):
    """The forward kernel's arithmetic in plain f32: per key tile, the
    running max m in log2 units from the raw scores times c = scale *
    log2 e, p = 2^(s*c - m), the rescale factor 1 where m did not move,
    l summing the unrounded p; lse = (m + log2 l) * ln 2.

    q, k, v: [B, T, H, D]. Returns (out [B, T, H, D], lse [B, H, T])."""
    b, t, h, d = q.shape
    c = (1.0 / math.sqrt(d)) * math.log2(math.e)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))   # [B, H, T, D]
    m = torch.full((b, h, t, 1), -math.inf)
    l = torch.zeros(b, h, t, 1)
    o = torch.zeros(b, h, t, d)
    for k0 in range(0, t, tile):
        s = qh @ kh[:, :, k0:k0 + tile].transpose(-1, -2)
        new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        alpha = torch.where(new == m, torch.ones_like(m),
                            torch.exp2(m - new))
        p = torch.exp2(s * c - new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p @ vh[:, :, k0:k0 + tile]
        m = new
    out = (o / l).transpose(1, 2)
    lse = ((m + torch.log2(l)) * math.log(2.0)).squeeze(-1)
    return out, lse


@pytest.mark.parametrize("t,h,d,mag", [(384, 3, 32, 1.0), (256, 2, 64, 1.0),
                                       (256, 2, 32, 8.0)])
def test_exp2_softmax_matches_dense_kernel_interpret(t, h, d, mag):
    """T=384 walks six key tiles; scores of q and k scaled x8 move each
    row's max across tiles by hundreds of log2 units."""
    rng = np.random.default_rng(t + d)
    q, k, v = (rng.standard_normal((1, t, h, d)).astype(np.float32)
               for _ in range(3))
    q, k = q * mag, k * mag
    want = block_attention.dense_flash_attention(
        *map(jnp.asarray, (q, k, v)), tile=128, interpret=True)
    out, lse = _exp2_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=FWD_TOL)
    _, twin_lse = k67.flash_attention_ref(
        *(torch.from_numpy(x).reshape(1, t, h * d) for x in (q, k, v)),
        n_heads=h, mode="dense")
    np.testing.assert_allclose(lse.numpy(), twin_lse.numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_sass_diff_counts_dropped_dense_instances_as_removed():
    """The check that K6 and K7 slab kept their SASS: OLD's mode-0 (dense)
    instances, which moved to flash_attention_dense.cu, are ``removed``
    and do not fail it; any other function NEW lacks still does."""
    from frankenstein_tpu_torch.tools import sass_diff
    old = {"flash_attn_fwdILi32ELi0EEEv": ["A"],
           "flash_attn_fwdILi32ELi1EEEv": ["B"],
           "flash_attn_bwd_dqILi64ELi2EEEv": ["C"]}
    new = {"flash_attn_fwdILi32ELi1EEEv": ["B"]}
    assert sass_diff.compare(old, new, [], r"ELi0EE") == {
        "flash_attn_fwdILi32ELi0EEEv": "removed",
        "flash_attn_fwdILi32ELi1EEEv": "same",
        "flash_attn_bwd_dqILi64ELi2EEEv": "missing"}
