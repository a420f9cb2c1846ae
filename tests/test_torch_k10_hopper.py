"""K10's Hopper design (``csrc/slab_rope_attention_int8.cu``) from the CPU.

- The Q pre-pass's twin (``slab_attention.rope_quantize_q_ref``) rotates q
  as the JAX package's ``rope.apply_rope_folded`` does and quantizes each
  (row, head) by the JAX kernel's rule: codes bitwise ``jnp.round(qf /
  sb)`` on the same scales, scales bitwise the IEEE f32 rule max|q| / 127
  + 1e-12 (the JAX interpret path's own scales differ from it by at most
  one unit in the last place: it multiplies by 1/127).
- A Python mirror of the forward's int8 tile schedule (K1's slab walk, on
  the kernel's own shapes) and of its epilogue's dequantise order,
  (float(dot) * (scale * s_k[chunk of the tile])) * s_q[row] in f32, then
  the log2-unit online softmax in float64, gives the twin's out and lse
  (``slab_rope_attention_int8_ref``) within K10_OUT_TOL / K10_LSE_TOL, the
  card's tolerances, at D = 32 and 64 and P in {8, 96, 256}.
- Every kernel of the source, K10's K pre-pass among them, falls in
  ``chip_smoke.py``'s "K10" profile family in the spellings a profiler may
  report, never in K1's or K6 / K7's.

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
from frankenstein_tpu_torch.tools import k1_shape_sweep

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "frankenstein_tpu_torch" / "csrc" /
          "slab_rope_attention_int8.cu")
KERNELS = ("slab_rope_attn_fwd_int8_prep", "slab_rope_attn_fwd_int8_wgmma")
K_PREPASS = ("rope_absmax_k", "rope_quantize_k")
KERNEL_RE = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\("
# the forward's shapes as Int8Of has them: head_dim -> (consumer
# warpgroups, key tile)
SHAPES = {32: (2, 64), 64: (3, 64)}
K10_OUT_TOL = 1e-2   # out, relative to max |twin| (chip_smoke.py's)
K10_LSE_TOL = 1e-4   # lse, absolute (chip_smoke.py's)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _chip_smoke():
    return _load("chip_smoke", ROOT / "chip_smoke.py")


def _k1_schedule():
    """K1's forward schedule mirror, which K10's forward walks too."""
    return _load("k1_hopper_mirror",
                 ROOT / "tests" / "test_torch_k1_hopper.py")._fwd_schedule


def _inputs(seed, b, t, h, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h * d)).astype(dtype)
               for _ in range(3))
    cache = jrope.build_rope_cache(d, t)
    cos, sin = trope.folded_tables(torch.tensor(np.asarray(cache)), 1)
    return q, k, v, cos, sin


@pytest.mark.parametrize("d", [32, 64])
def test_q_prep_twin_is_the_jax_rule(d):
    b, t, h = 2, 1024, 3
    q, _, _, cos, sin = _inputs(d + 7, b, t, h, d)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    codes, scales = slab_attention.rope_quantize_q_ref(qb, cos, sin,
                                                       n_heads=h)
    assert codes.dtype == torch.int8 and codes.shape == (b, t, h * d)
    assert scales.dtype == torch.float32 and scales.shape == (b, h, t)
    cos_e, sin_e = (jnp.asarray(x.repeat(1, h).numpy()) for x in (cos, sin))
    qf = jrope.apply_rope_folded(jnp.asarray(q).astype(jnp.bfloat16), cos_e,
                                 sin_e).astype(jnp.float32)
    qf = qf.reshape(b, t, h, d)
    # the scales: the IEEE f32 rule bitwise; the JAX path's within an ulp
    mx = np.abs(np.asarray(qf)).max(axis=-1)                     # [B, T, H]
    want = mx / np.float32(127) + np.float32(1e-12)
    got = scales.numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(got, want)
    jax_s = np.asarray(jnp.max(jnp.abs(qf), axis=-1) / 127.0 + 1e-12)
    assert np.all(np.abs(got.view(np.int32) - jax_s.view(np.int32)) <= 1)
    # the codes: the JAX kernel's jnp.round(qf / sb) on those scales
    sb = jnp.asarray(got)[..., None]
    jcodes = np.asarray(jnp.round(qf / sb).astype(jnp.int8))
    np.testing.assert_array_equal(codes.numpy().reshape(b, t, h, d), jcodes)
    assert int(codes.abs().max()) == 127


def test_twin_quantizes_q_as_the_prepass_twin():
    """The int8 twin's scores use the Q pre-pass twin's codes and scales:
    its lse equals a recomputation from rope_quantize_q_ref and
    rope_quantize_k_ref."""
    b, t, h, d, p = 1, 1024, 2, 32, 256
    q, k, v, cos, sin = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                         else x for x in _inputs(5, b, t, h, d))
    _, lse = slab_attention.slab_rope_attention_int8_ref(
        q, k, v, cos, sin, n_heads=h, tok_per_time=p)
    q8, qs = slab_attention.rope_quantize_q_ref(q, cos, sin, n_heads=h)
    k8, ks = slab_attention.rope_quantize_k_ref(k, cos, sin, n_heads=h)
    scale = 1.0 / math.sqrt(d)
    i = torch.arange(t)
    seen = (i[None, :] // p) <= (i[:, None] // p)
    for head in range(h):
        cols = slice(head * d, (head + 1) * d)
        dots = q8[0, :, cols].float() @ k8[0, :, cols].float().t()
        ssk = (scale * ks[0, head]).repeat_interleave(1024)
        s = (dots * ssk[None, :]) * qs[0, head][:, None]
        s = s.masked_fill(~seen, -math.inf)
        torch.testing.assert_close(lse[0, head], torch.logsumexp(s, -1),
                                   rtol=0, atol=1e-5)


def test_mirror_shapes_are_the_sources():
    found = re.search(r"using Int8Of = Int8Pass<D, D == 32 \? (\d+) : (\d+),"
                      r" (\d+),", SOURCE.read_text())
    assert found, "Int8Of's line changed: update SHAPES"
    nwg32, nwg64, bn = map(int, found.groups())
    assert SHAPES == {32: (nwg32, bn), 64: (nwg64, bn)}
    assert 1024 % bn == 0     # a key tile lies in one scale chunk
    # the shape sweep's --int8 mode rewrites this line; production first
    source, line = k1_shape_sweep.KINDS[True][:2]
    assert source == SOURCE and len(line.findall(SOURCE.read_text())) == 1
    for d, (nwg, bn) in SHAPES.items():
        assert k1_shape_sweep.CANDIDATES[d][0][:2] == (nwg, bn)


def _int8_mirror(q8, qs, k8, ks, v, t, p, nwg, bn, scale, schedule):
    """K10's forward on one head: [T, D] codes q8, k8 (int64), [T] row
    scales qs and [T / 1024] chunk scales ks (f32), [T, D] v -> (out [T,
    D], lse [T]). Tile by tile over the tiles each warpgroup walks: the
    integer dots exact, dequantized in f32 in the kernel's order with the
    scale of the tile's chunk, invisible keys of a masked tile at -inf,
    the running max in log2 units, lse = (m + log2 l) * ln 2 (float64)."""
    f32 = np.float32
    c = math.log2(math.e)
    out, lse = np.zeros((t, v.shape[1])), np.zeros(t)
    for first, _, walked, _, masked in schedule(t, p, nwg, bn):
        rows = np.arange(first, min(first + 64, t))
        ends = np.minimum(t, (rows // p + 1) * p)
        m = np.full(len(rows), -np.inf)
        l, o = np.zeros(len(rows)), np.zeros((len(rows), v.shape[1]))
        for j in walked:
            keys = np.arange(j * bn, (j + 1) * bn)
            ssk = f32(scale) * ks[j * bn // 1024]
            dots = (q8[rows] @ k8[keys].T).astype(f32)
            s = ((dots * ssk) * qs[rows][:, None]).astype(np.float64)
            if j in masked:
                s = np.where(keys[None, :] >= ends[:, None], -np.inf, s)
            n = np.maximum(m, s.max(axis=1) * c)
            a = np.where(n == m, 1.0, np.exp2(m - n))
            e = np.exp2(s * c - n[:, None])
            l, o, m = l * a + e.sum(axis=1), o * a[:, None] + e @ v[keys], n
        out[rows], lse[rows] = o / l[:, None], (m + np.log2(l)) * math.log(2)
    return out, lse


@pytest.mark.parametrize("p", [8, 96, 256])
@pytest.mark.parametrize("d", sorted(SHAPES))
def test_int8_mirror_matches_the_twin(d, p):
    b, t, h = 1, 2048, 2
    nwg, bn = SHAPES[d]
    q, k, v, cos, sin = _inputs(d * 100 + p, b, t, h, d)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = slab_attention.slab_rope_attention_int8_ref(
        q, k, v, cos, sin, n_heads=h, tok_per_time=p)
    q8, qs = slab_attention.rope_quantize_q_ref(q, cos, sin, n_heads=h)
    k8, ks = slab_attention.rope_quantize_k_ref(k, cos, sin, n_heads=h)
    schedule = _k1_schedule()
    top = float(out.abs().max())
    for head in range(h):
        cols = slice(head * d, (head + 1) * d)
        got_out, got_lse = _int8_mirror(
            q8[0, :, cols].numpy().astype(np.int64), qs[0, head].numpy(),
            k8[0, :, cols].numpy().astype(np.int64), ks[0, head].numpy(),
            v[0, :, cols].numpy().astype(np.float64), t, p, nwg, bn,
            1.0 / math.sqrt(d), schedule)
        assert np.abs(got_lse - lse[0, head].numpy()).max() <= K10_LSE_TOL
        assert (np.abs(got_out - out[0, :, cols].numpy()).max()
                <= K10_OUT_TOL * top)


def test_int8_mirror_sees_a_wrong_chunk_scale():
    """The mirror's check has power: reading chunk 0's K scale for every
    tile (the smoke's negative control) moves lse past K10_LSE_TOL."""
    b, t, h, d, p = 1, 2048, 1, 32, 256
    q, k, v, cos, sin = _inputs(3, b, t, h, d)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = slab_attention.slab_rope_attention_int8_ref(
        q, k, v, cos, sin, n_heads=h, tok_per_time=p)
    q8, qs = slab_attention.rope_quantize_q_ref(q, cos, sin, n_heads=h)
    k8, ks = slab_attention.rope_quantize_k_ref(k, cos, sin, n_heads=h)
    assert float(ks[0, 0, 0]) != float(ks[0, 0, 1])
    wrong = np.full_like(ks[0, 0].numpy(), float(ks[0, 0, 0]))
    _, got = _int8_mirror(q8[0].numpy().astype(np.int64), qs[0, 0].numpy(),
                          k8[0].numpy().astype(np.int64), wrong,
                          v[0].numpy().astype(np.float64), t, p,
                          *SHAPES[d], 1.0 / math.sqrt(d), _k1_schedule())
    assert np.abs(got - lse[0, 0].numpy()).max() > K10_LSE_TOL


def _spellings(name: str) -> dict:
    """The symbol, the demangled template instance and the mangled one, as
    nvcc names the D = 32 instances."""
    anon = "_GLOBAL__N__5d1e3c4a_27_slab_rope_attention_int8_cu_8b1c0f2e"
    head = f"_ZN{len(anon)}{anon}{len(name)}{name}"
    if name.endswith("_prep"):
        return {"bare": name,
                "demangled": f"void (anonymous namespace)::{name}<32, true, "
                             "false>(__nv_bfloat16 const*, float const*, float "
                             "const*, signed char*, float*, int, int, "
                             "unsigned long)",
                "mangled": f"{head}ILi32ELb1ELb0EEEvPK13__nv_bfloat16PKfS5_PaPfiim"}
    if name.startswith("rope_"):
        return {"bare": name,
                "demangled": f"void (anonymous namespace)::{name}<32, "
                             "true>(__nv_bfloat16 const*, float const*, "
                             "float const*, unsigned int*, int, int)",
                "mangled": f"{head}ILi32ELb1EEEvPK13__nv_bfloat16PKfS5_Pjii"}
    return {"bare": name,
            "demangled": f"void (anonymous namespace)::{name}<(anonymous "
                         "namespace)::Int8Pass<32, 2, 64, 2, false, 0> >("
                         "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                         "float const*, float const*, __nv_bfloat16*, "
                         "float*, int, int, int, float)",
            "mangled": f"{head}INS_8Int8PassILi32ELi2ELi64ELi2ELb0ELi0EEEEEv14"
                       "CUtensorMap_stS3_S3_PKfS5_P13__nv_bfloat16Pfiiif"}


@pytest.mark.parametrize("form", ["bare", "demangled", "mangled"])
@pytest.mark.parametrize("name", KERNELS + K_PREPASS)
def test_k10_kernels_fall_in_the_k10_family(name, form):
    family = _chip_smoke()._family(_spellings(name)[form])
    assert family == "K10"
    assert family not in ("K1", "K6 fwd", "K7 fwd")


def test_k10_kernel_names_are_the_sources_kernels():
    text = SOURCE.read_text()
    kernels = re.findall(KERNEL_RE, text)
    assert sorted(kernels) == sorted(KERNELS + K_PREPASS)
    for name in KERNELS:
        assert name.startswith("slab_rope_attn_fwd_int8_")
    for name in kernels:
        assert "flash_attn_fwd" not in name
    assert "flash_attn_fwd" not in text.split("#include")[-1]
    # the K pre-pass K10 runs lives beside K10's kernels, its entry point
    # before theirs
    assert 'extern "C" int fk_slab_rope_k_quant(' in text
    assert text.index('extern "C" int fk_slab_rope_k_quant(') < text.index(
        'extern "C" int fk_slab_rope_attention_fwd_int8(')
    for name in K_PREPASS:
        assert re.search(rf"void __launch_bounds__\(QK_THREADS\)\s*{name}\(",
                         text), name
