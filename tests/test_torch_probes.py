"""The probe modes of K1's and K10's wgmma forwards
(``ops/cuda/slab_probe.py``): their plain twins against the JAX probes
``tools/attn_probe.py`` and ``tools/int8_attr_probe.py`` run in Pallas
interpret mode, the int8 twins against a numpy float64 oracle on
bf16-lattice inputs, the dots-only twins against a direct sum over the
forwards' visit set, every JAX variant's port mode, the sources that
define the probes' entry points, the wrapper's gates, and the two probe
CLIs (``frankenstein_tpu_torch.tools``) on the CPU.

The JAX probes pack 4 heads of D=32 into 128 lanes ([nb, T, 128]); the
port's [B, T, E] layout with 4 heads is the same array. Inputs are f32
draws, as the JAX package's own attention tests use: off the bf16 lattice,
the JAX int8 path's scales agree with the port's IEEE quotient (the tie gap
on the lattice is a finding in the JAX package, ``ROADMAP.md`` section 3).
"""

import ast
import functools
import importlib.util
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from frankenstein_tpu_torch.ops.cuda import slab_probe as sp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
T, NPACK, D = 2048, 4, 32
TOL = 1e-5   # out absolute; lse relative to max(1, |lse|)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_probe_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probe():
    """(tool, variant, seed) -> (out, lse) numpy of the JAX probe at nb=1,
    T=2048 in Pallas interpret mode: each tool module gets a copy of its
    ``pl`` namespace whose ``pallas_call`` interprets. Cached per run."""
    tools = {name: _load_tool(name) for name in ("attn_probe",
                                                 "int8_attr_probe")}
    interp = types.SimpleNamespace(**vars(pl))
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    with pytest.MonkeyPatch.context() as mp:
        for mod in tools.values():
            mp.setattr(mod, "pl", interp)

        @functools.lru_cache(maxsize=None)
        def run(tool, variant, seed):
            q, k, v = (jnp.asarray(a) for a in _draws(seed))
            call = (tools[tool]._variant_call if tool == "attn_probe"
                    else tools[tool]._call)
            out, lse = call(q, k, v, variant)
            return np.asarray(out), np.asarray(lse)

        yield run


def _draws(seed, lattice=False):
    """q, k, v [1, T, 128] f32, standard normal (on the bf16 lattice with
    ``lattice``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = rng.standard_normal((1, T, NPACK * D)).astype(np.float32)
        if lattice:
            x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        out.append(x)
    return out


def _port(variant, p, seed, lattice=False, dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _draws(seed, lattice))
    before = (sp.launches, sp.launches_int8)
    out, lse = sp.slab_attention_probe(q, k, v, n_heads=NPACK,
                                       tok_per_time=p, variant=variant)
    assert (sp.launches, sp.launches_int8) == before   # CPU: the twin
    return out.float().numpy(), lse.numpy()


def _close(got, want):
    (out, lse), (want_out, want_lse) = got, want
    np.testing.assert_allclose(out, want_out, rtol=0, atol=TOL)
    assert np.all(np.abs(lse - want_lse)
                  <= TOL * np.maximum(1.0, np.abs(want_lse)))


@pytest.mark.parametrize("jax_variant,variant", [
    ("kernel", "kernel"), ("kernel", "mask_all"), ("mask_last", "kernel"),
    ("mask_last", "mask_all")])
def test_attn_probe_twins_match_jax_interpret(jax_probe, jax_variant,
                                              variant):
    """At the tool's own P=8 (``BLOCK``): K1's twin on unrotated inputs is
    the JAX probe's reference kernel and its mask_last variant (exact, as
    every chunk before a q-block's last is fully visible)."""
    _close(_port(variant, 8, 1), jax_probe("attn_probe", jax_variant, 1))


def _row_max_scores(seed, p):
    """[1, H, T] float64: each row's largest visible score q.k / sqrt(D)."""
    q, k, _ = (a.reshape(T, NPACK, D).astype(np.float64)
               for a in _draws(seed))
    s = np.einsum("qhd,khd->hqk", q, k) / np.sqrt(D)
    i = np.arange(T)
    s[:, ~((i[None, :] // p) <= (i[:, None] // p))] = -np.inf
    return s.max(-1)[None]


def test_exp2_twin_and_the_jax_lse_in_log2_units(jax_probe):
    """``exp2``: out within TOL of the JAX variant's. Its lse is the JAX
    reference kernel's (the port writes m ln 2 + ln l); the JAX variant's
    lse is m log2(e) + ln l with m the row's largest score, log2(e) - 1
    times m off the true one (tools/attn_probe.py:71, :133-134)."""
    out, lse = _port("exp2", 8, 2)
    jax_out, jax_lse = jax_probe("attn_probe", "exp2", 2)
    np.testing.assert_allclose(out, jax_out, rtol=0, atol=TOL)
    _close((out, lse), (jax_out, jax_probe("attn_probe", "kernel", 2)[1]))
    want = jax_probe("attn_probe", "kernel", 2)[1] + (
        _row_max_scores(2, 8) * (np.log2(np.e) - 1.0))
    np.testing.assert_allclose(jax_lse, want, rtol=0, atol=1e-4)
    assert np.abs(jax_lse - lse).max() > 0.1


@pytest.mark.parametrize("variant", ["bf16", "int8_full",
                                     "int8_cheap_dequant", "int8_noquant"])
def test_int8_probe_twins_match_jax_interpret(jax_probe, variant):
    """At the tool's P=256: the bf16 reference, K10's twin on unrotated
    inputs (int8_full) and the two defined variants, out within TOL and lse
    within TOL relative (cheap_dequant's lse reaches 1e4, noquant's 4e2)."""
    _close(_port(variant, 256, 3), jax_probe("int8_attr_probe", variant, 3))


def _oracle_codes(x, axes):
    """K10's documented arithmetic in IEEE f32: s = max|x| / 127 + 1e-12,
    codes round_half_even(x / s)."""
    mx = np.abs(x).max(axis=axes, keepdims=True)
    s = mx / np.float32(127.0) + np.float32(1e-12)
    return np.round(x / s), s


def int8_oracle(q, k, v, p, variant):
    """float64 softmax attention over one batch of [T, H*D] f32 inputs (no
    rotation) with the scores of ``variant``: codes and scales from
    ``_oracle_codes`` (or round(8 x) for int8_noquant), the integer dots
    and the dequantization in float64. Returns (out [T, H*D], lse [H, T])."""
    qh, kh, vh = (a.reshape(T, NPACK, D) for a in (q, k, v))
    scale = 1.0 / np.sqrt(D)
    if variant == "int8_noquant":
        q8, k8 = np.round(qh * np.float32(8)), np.round(kh * np.float32(8))
        sq = sk = None
    else:
        q8, sq = _oracle_codes(qh, (2,))                       # [T, H, 1]
        k8, sk = _oracle_codes(kh.reshape(T // 1024, 1024, NPACK, D), (1, 3))
        k8 = k8.reshape(T, NPACK, D)
        sk = np.repeat(sk[:, 0, :, 0], 1024, axis=0)            # [T, H]
    s = np.einsum("qhd,khd->hqk", q8.astype(np.float64),
                  k8.astype(np.float64)) * scale
    if variant == "int8_full":
        s = s * sk.T.astype(np.float64)[:, None, :] * (
            sq[..., 0].T.astype(np.float64)[:, :, None])
    i = np.arange(T)
    s[:, ~((i[None, :] // p) <= (i[:, None] // p))] = -np.inf
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    lse = (m + np.log(e.sum(-1, keepdims=True)))[..., 0]
    out = np.einsum("hqk,khd->qhd", e / e.sum(-1, keepdims=True),
                    vh.astype(np.float64))
    return out.reshape(T, NPACK * D), lse


@pytest.mark.parametrize("variant", ["int8_full", "int8_cheap_dequant",
                                     "int8_noquant"])
def test_int8_twins_match_float64_oracle_on_bf16_lattice(variant):
    """Unit-scale draws on the bf16 lattice (the serving dtype's values,
    where .5 ties in x / s are common): the twins' lse within TOL relative
    of the float64 oracle of the documented math. out within TOL times the
    largest |lse|: the twins' f32 scores of magnitude L carry an absolute
    error of about L * 2^-24, and their softmax passes it on."""
    q, k, v = _draws(4, lattice=True)
    out, lse = _port(variant, 256, 4, lattice=True)
    want_out, want_lse = int8_oracle(q[0], k[0], v[0], 256, variant)
    assert np.all(np.abs(lse[0] - want_lse)
                  <= TOL * np.maximum(1.0, np.abs(want_lse)))
    np.testing.assert_allclose(out[0], want_out, rtol=0,
                               atol=TOL * max(1.0, np.abs(want_lse).max()))


@pytest.mark.parametrize("variant,p", [("dots_only", 8), ("dots_only", 256),
                                       ("int8_dots_only", 8),
                                       ("int8_dots_only", 256)])
def test_dots_only_twins_sum_over_the_visit_set(variant, p):
    """The dots-only modes: out_i = sum over the keys j the forward visits
    for row i (its 64-row warpgroup's 64-key tiles up to the warpgroup's
    last slab end) of the score, rounded to v's dtype, times v_j; no
    softmax, lse 0. Against a direct float64 sum: dots_only on f32 draws
    (no rounding), int8_dots_only on bf16 ones (its integer dots round to
    bf16 as the forward's A-fragments do), within the bf16 rounding of
    out. At P=8 a warpgroup spans eight slabs, so the visit set reaches
    past the slab mask."""
    bf16 = variant == "int8_dots_only"
    q, k, v = (a[0].reshape(T, NPACK, D).astype(np.float64)
               for a in _draws(5, lattice=bf16))
    if bf16:
        s = np.einsum("qhd,khd->hqk", np.round(q * 8), np.round(k * 8))
        s = s.astype(ml_dtypes.bfloat16).astype(np.float64)
    else:
        s = np.einsum("qhd,khd->hqk", q, k) / np.sqrt(D)
    i = np.arange(T)
    ends = np.minimum(T, ((i // 64 * 64 + 63) // p + 1) * p)
    ends = np.minimum(T, (ends + 63) // 64 * 64)
    s[:, ~(i[None, :] < ends[:, None])] = 0.0
    want = np.einsum("hqk,khd->qhd", s, v).reshape(T, NPACK * D)
    out, lse = _port(variant, p, 5, lattice=bf16,
                     dtype=torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_allclose(out[0], want, rtol=2 ** -8 if bf16 else 1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert not lse.any()
    if p == 8:
        assert (ends > np.minimum(T, (i // p + 1) * p)).any()


def test_visit_set_and_counts():
    """The forwards' visit set equals the slab mask where P % 64 == 0 and
    reaches past it at P=8; no_mask's twin is then K1's twin. Tile counts:
    a 64-row warpgroup visits ceil(end / 64) tiles, end its last row's slab
    end (K1's nkw)."""
    assert torch.equal(sp.visit_ends(6144, 256), sp.slab_ends(6144, 256))
    ends = sp.visit_ends(256, 8)
    assert ends[:64].tolist() == [64] * 64
    assert ends[64:128].tolist() == [128] * 64 and ends[128].item() == 192
    assert sp.visited_tiles(6144, 256) == sum(
        ((w * 64) // 256 + 1) * 4 for w in range(6144 // 64))
    assert sp.visited_tiles(256, 8) == 1 + 2 + 3 + 4
    q, k, v = (torch.from_numpy(a) for a in _draws(6))
    got = sp.slab_attention_probe(q, k, v, n_heads=NPACK, tok_per_time=256,
                                  variant="no_mask")
    want = sp.slab_attention_probe(q, k, v, n_heads=NPACK, tok_per_time=256,
                                   variant="kernel")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    masked = sp.slab_attention_probe(q, k, v, n_heads=NPACK, tok_per_time=8,
                                     variant="kernel")
    unmasked = sp.slab_attention_probe(q, k, v, n_heads=NPACK,
                                       tok_per_time=8, variant="no_mask")
    assert float((masked[0] - unmasked[0]).abs().max()) > 1e-2


def _jax_variants(tool):
    """The variant names the JAX tool's ``main`` times, read from its
    source (its loop ``for variant in (...)``)."""
    tree = ast.parse((ROOT / "tools" / f"{tool}.py").read_text())
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    loops = [node for node in ast.walk(main) if isinstance(node, ast.For)
             and getattr(node.target, "id", None) == "variant"]
    assert len(loops) == 1, tool
    return ast.literal_eval(loops[0].iter)


def _enum(source, name):
    """{member: value} of ``enum name`` in a CUDA source."""
    body = re.search(rf"enum {name} : int {{([^}}]*)}};", source).group(1)
    return {m: int(v) for m, v in re.findall(r"(\w+) = (\d+)", body)}


def test_every_jax_probe_variant_has_a_mode():
    """Every variant the two JAX tools time maps to a port mode, the
    number the C entry points dispatch on (``enum Mode`` of K1's forward
    for the bf16 modes, ``enum Variant`` of K10's for the int8 ones). The
    names that share the production K1 instance are ``kernel``, ``bf16``,
    ``mask_last`` and ``exp2``, which is a stated alias of ``kernel``; the
    port CLIs time every JAX variant but ``mask_last`` (``kernel`` masks
    only the tiles that cross a warpgroup's first slab)."""
    from frankenstein_tpu_torch.tools import attn_probe, int8_attr_probe
    jax_attn = _jax_variants("attn_probe")
    jax_int8 = _jax_variants("int8_attr_probe")
    assert set(jax_attn) | set(jax_int8) <= set(sp.PROBE_VARIANTS)
    assert set(attn_probe.VARIANTS) == set(jax_attn) - {"mask_last"} | {
        "mask_all"}
    assert int8_attr_probe.VARIANTS == jax_int8
    assert sp.ALIASES == {"exp2": "kernel"}
    kernel = sp.PROBE_VARIANTS["kernel"]
    assert [name for name, mode in sp.PROBE_VARIANTS.items()
            if mode == kernel] == ["kernel", "bf16", "mask_last", "exp2"]
    csrc = ROOT / "frankenstein_tpu_torch" / "csrc"
    fwd = _enum((csrc / "slab_rope_attention_fwd.cu").read_text(), "Mode")
    int8 = _enum((csrc / "slab_rope_attention_int8.cu").read_text(),
                 "Variant")
    c_name = lambda name: "PROD" if mode == kernel else name.upper()
    for name, mode in sp.PROBE_VARIANTS.items():
        enum = int8 if sp.is_int8(name) else fwd
        assert enum[c_name(name)] == mode, name
    assert sorted(fwd.values()) + sorted(int8.values()) == sorted(
        set(sp.PROBE_VARIANTS.values()))


ENTRY_RE = r'extern "C" (?:int|long long|const char\*) (\w+)\('


def test_probe_and_prepass_symbols_defined_once():
    """The mma.sync attention source is gone. K10's K pre-pass entry
    point, the library's error text and the probes' entry points are each
    defined in exactly one source: the bf16 probes beside K1's forward,
    the int8 probes and the K pre-pass beside K10's. Every entry point
    ``build.py`` binds is defined once."""
    from frankenstein_tpu_torch.ops.cuda import build
    csrc = ROOT / "frankenstein_tpu_torch" / "csrc"
    assert not (csrc / "slab_rope_attention.cu").exists()
    defined = {}
    for src in sorted(csrc.glob("*.cu")):
        for name in re.findall(ENTRY_RE, src.read_text()):
            defined.setdefault(name, []).append(src.name)
    fwd, int8 = "slab_rope_attention_fwd.cu", "slab_rope_attention_int8.cu"
    assert {name: defined.get(name) for name in (
        "fk_slab_rope_k_quant", "fk_error_string", "fk_slab_attention_probe",
        "fk_slab_attention_probe_occupancy", "fk_slab_attention_probe_int8",
        "fk_slab_attention_probe_int8_occupancy")} == {
        "fk_slab_rope_k_quant": [int8], "fk_error_string": [fwd],
        "fk_slab_attention_probe": [fwd],
        "fk_slab_attention_probe_occupancy": [fwd],
        "fk_slab_attention_probe_int8": [int8],
        "fk_slab_attention_probe_int8_occupancy": [int8]}
    bound = set(re.findall(r"lib\.(fk_\w+)\.argtypes",
                           Path(build.__file__).read_text()))
    bound |= set(re.findall(r'"(fk_\w+_occupancy)"',
                            Path(build.__file__).read_text()))
    assert bound <= set(defined)
    assert all(len(defined[name]) == 1 for name in bound)


def test_wrapper_gates():
    """The gate: CUDA takes bf16 at head_dim 32 and T % 128 == 0 (and T %
    1024 == 0 for the int8 modes, on every device); the CPU takes every
    variant with a twin. Refused inputs raise, never run a twin."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert sp.supported("cuda", bf16, 6144, 256, 8, "int8_full")
    assert sp.supported("cuda", bf16, 6144, 256, 8, "no_kbd")
    assert not sp.supported("cuda", bf16, 6144, 512, 8, "kernel")   # D=64
    assert not sp.supported("cuda", f32, 6144, 256, 8, "kernel")
    assert not sp.supported("cuda", bf16, 6272, 256, 8, "int8_noquant")
    assert sp.supported("cuda", bf16, 6272, 256, 8, "exp2")
    assert not sp.supported("cpu", f32, 2048, 128, 4, "no_kbd")
    assert not sp.supported("cpu", f32, 1152, 128, 4, "int8_full")
    assert not sp.supported("cpu", f32, 2048, 128, 4, "sdpa")
    q = torch.zeros(1, 1152, 128)
    with pytest.raises(ValueError, match="no plain twin"):
        sp.slab_attention_probe(q, q, q, n_heads=4, tok_per_time=8,
                                variant="no_kbd")
    with pytest.raises(ValueError, match="does not take"):
        sp.slab_attention_probe(q, q, q, n_heads=4, tok_per_time=256,
                                variant="int8_noquant")
    with pytest.raises(ValueError, match="unknown probe variant"):
        sp.slab_attention_probe(q, q, q, n_heads=4, tok_per_time=8,
                                variant="mask_first")
    with pytest.raises(ValueError, match="CUDA"):
        sp.probe_quantize_k(q, n_heads=4, variant="int8_full")


@pytest.mark.parametrize("tool", ["attn_probe", "int8_attr_probe"])
def test_probe_cli_needs_a_gpu_unless_asked_for_the_cpu(tool):
    """Without a GPU the CLI exits non-zero with a message and prints no
    result; ``--device cpu`` runs every variant's twin end to end (one JSON
    line per variant on stderr, all results on stdout), with no times."""
    mod = f"frankenstein_tpu_torch.tools.{tool}"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    refused = subprocess.run([sys.executable, "-m", mod, "1"], cwd=ROOT,
                             capture_output=True, text=True, timeout=300,
                             env=env)
    assert refused.returncode != 0 and "--device cpu" in refused.stderr
    assert not refused.stdout.strip()
    ran = subprocess.run([sys.executable, "-m", mod, "1", "--device", "cpu"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert ran.returncode == 0, ran.stderr[-3000:]
    res = json.loads(ran.stdout.strip().splitlines()[-1])
    variants = res["variants"]
    assert (res["device"], res["batch"], res["t"]) == ("cpu", 1, 2048)
    assert [list(json.loads(line)) for line in
            ran.stderr.strip().splitlines()] == [[v] for v in variants]
    for name in variants:
        assert res[f"{name}_ms"] is None
        assert res[f"{name}_finite"] is (None if name == "no_kbd" else True)


def test_probe_error_limits_and_no_kbd_guard():
    """The one rule the smoke and the card tests hold a mode to: out error
    relative to max |twin|; lse absolute for the exact modes, relative to
    max(1, |lse|) for the defined ones; no_kbd's guard over its leading
    rows against kernel's output."""
    ref = torch.tensor([[1.0, -4.0]])
    lse = torch.tensor([[2.0, 1000.0]])
    out = ref + torch.tensor([[0.0, 0.0625]])
    err = sp.probe_error("kernel", out, lse + 2 ** -10, ref, lse)
    assert err == (2 ** -6, 2 ** -10)
    assert not sp.agrees("kernel", err)
    err = sp.probe_error("no_mask", out, lse + torch.tensor([[0.0, 0.0625]]),
                         ref, lse)
    assert err == pytest.approx((2 ** -6, 6.25e-5), rel=1e-6)
    assert sp.agrees("no_mask", err)
    assert not sp.agrees("no_mask", (0.021, 0.0))
    assert not sp.agrees("int8_full", (0.011, 0.0))
    x = torch.zeros(3, 4)
    guard = sp.no_kbd_guard(x, x[:, :2], (x.clone(), x[:, :2].clone()),
                            x[:2] + 0.5)
    assert guard == (True, True, 0.5) and sp.guard_holds(guard)
    assert not sp.guard_holds(sp.no_kbd_guard(x, x, (x, x), x[:1] + 0.05))
    bad = x.clone()
    bad[2, 0] = float("nan")
    assert not sp.guard_holds(sp.no_kbd_guard(bad, x, (bad, x), x[:1] + 1))


def test_sass_diff_maps_renamed_templates():
    """sass_diff's comparison: OLD's functions renamed by the --map regex
    substitutions, then held line by line to NEW's; a changed line, a
    longer body and a function NEW lacks are each reported."""
    from frankenstein_tpu_torch.tools import sass_diff
    old = {"fwdILi32ELb1EEEv": ["A", "B"], "fwdILi32ELb0EEEv": ["A", "B"],
           "qkILi32EEEv": ["C"], "gone": ["D"]}
    new = {"fwdILi32ELb1ELb1ELi0EEEv": ["A", "B"],
           "fwdILi32ELb0ELb1ELi0EEEv": ["A", "X", "Y"],
           "qkILi32ELb1EEEv": ["C"], "fwdILi32ELb1ELb0ELi5EEEv": ["E"]}
    maps = [(r"(fwdILi\d+ELb\d)EEE", r"\1ELb1ELi0EEE"),
            (r"(qkILi\d+)EEE", r"\1ELb1EEE")]
    assert sass_diff.compare(old, new, maps) == {
        "fwdILi32ELb1EEEv": "same", "fwdILi32ELb0EEEv": "differs (2 lines)",
        "qkILi32EEEv": "same", "gone": "missing"}
    name = ("_ZN55_GLOBAL__N__972e2ccc_22_slab_rope_attention_cu_033ae946"
            "18slab_rope_attn_fwdILi32ELb1EEEv")
    assert sass_diff.ANON.sub("", name) == (
        "_ZN5522_slab_rope_attention_cu_18slab_rope_attn_fwdILi32ELb1EEEv")


def test_sass_diff_ignores_what_the_rest_of_the_cubin_sets():
    """cuobjdump pads a cubin's columns to its widest instruction and
    numbers branch labels across it: a function moved to another source
    keeps its SASS but not those. canonical() takes both out (labels from
    0 in order of appearance), and a changed instruction still shows."""
    from frankenstein_tpu_torch.tools import sass_diff
    old = ["/*0000*/   BRA `(.L_x_7) ;   /* 0x1 */", ".L_x_7:",
           "/*0010*/   EXIT ;   /* 0x2 */", "/*0020*/   BRA `(.L_x_9) ;"]
    new = ["/*0000*/ BRA `(.L_x_31) ; /* 0x1 */", ".L_x_31:",
           "/*0010*/ EXIT ; /* 0x2 */", "/*0020*/ BRA `(.L_x_40) ;"]
    assert sass_diff.canonical(old) == sass_diff.canonical(new) == [
        "/*0000*/ BRA `(.L_x_0) ; /* 0x1 */", ".L_x_0:",
        "/*0010*/ EXIT ; /* 0x2 */", "/*0020*/ BRA `(.L_x_1) ;"]
    moved = {"f": sass_diff.canonical(old)}
    assert sass_diff.compare(moved, {"f": sass_diff.canonical(new)},
                             []) == {"f": "same"}
    changed = sass_diff.canonical(new[:2] + ["/*0010*/ RET ; /* 0x2 */"]
                                  + new[3:])
    assert sass_diff.compare(moved, {"f": changed}, []) == {
        "f": "differs (1 lines)"}

