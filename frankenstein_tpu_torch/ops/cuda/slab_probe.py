"""The packed-attention probes: K1's and K10's wgmma forwards in their
probe modes.

They replace ``tools/attn_probe.py:_variant_call`` and
``tools/int8_attr_probe.py:_call``, which priced each component of the
packed TPU forward by timing a variant of the kernel with that component
removed. Here each variant is a compile-time mode of the production
templates, run on UNROTATED q and k at head_dim 32, as the JAX probes omit
RoPE: the bf16 variants are instances of K1's forward
(``csrc/slab_rope_attention_fwd.cu``, ``FwdPass``'s MODE) with no rotation
pre-pass, the int8 variants K10's two pre-passes without the rotation,
then an instance of K10's forward (``csrc/slab_rope_attention_int8.cu``,
``Int8Pass``'s MODE). So they price the design that runs. The port follows
the math contract, not the TPU schedule: where a variant removes TPU-only
machinery, the mode removes the Hopper component that plays its role
(``no_kbd``: V read K-major instead of through the transpose-B bit).

``PROBE_VARIANTS`` maps the JAX probes' variant names to the modes.
``kernel`` (attn probe), ``bf16`` (int8 probe) and ``mask_last`` are the
production K1 instance itself, which masks only the tiles that cross a
warpgroup's first slab; ``mask_all`` masks every visited tile; ``exp2``
launches ``kernel``'s instance (``ALIASES``: the design already folds
log2 e into one FFMA before ex2); ``int8_full`` is production K10. A
mode's values are exact (K1's or K10's math), defined (a stated function,
not attention: the twins below say which) or, for ``no_kbd``, wrong by
design (timing only, no twin).

``slab_attention_probe`` launches the kernels for CUDA tensors and runs
the mode's plain PyTorch twin (``TWINS``) for CPU tensors; a CUDA input the
kernels do not take (``supported``) raises. The probes get no model-path
route: ``frankenstein_tpu_torch.tools.attn_probe`` and ``.int8_attr_probe``
time them.
"""

from __future__ import annotations

import ctypes

import torch

from frankenstein_tpu_torch.ops.cuda import build
from frankenstein_tpu_torch.ops.cuda import slab_attention as k1

HEAD_DIM = 32      # the probe modes are instantiated at D = 32 only
BQ = 128           # K1's and K10's T % 128 == 0
BK, WG_ROWS = 64, 64   # the forwards' key tile and a warpgroup's rows

# name -> the kernels' probe mode (enum Mode of slab_rope_attention_fwd.cu,
# enum Variant of slab_rope_attention_int8.cu)
PROBE_VARIANTS = {
    "kernel": 0, "bf16": 0, "mask_last": 0, "exp2": 0, "dots_only": 1,
    "no_kbd": 2, "no_mask": 3, "mask_all": 4, "int8_full": 5,
    "int8_dots_only": 6, "int8_cheap_dequant": 7, "int8_noquant": 8}
# a JAX variant whose change the wgmma design already has: it launches the
# named mode's instance
ALIASES = {"exp2": "kernel"}
INT8_FULL = 5      # modes from here on quantize Q and K (T % 1024 == 0)
CAST_ONLY = ("int8_dots_only", "int8_noquant")   # codes round(8 x)
# values exactly K1's or K10's math; the modes over the forward's visit set
EXACT = ("kernel", "bf16", "mask_last", "mask_all", "exp2", "int8_full")
UNMASKED = ("dots_only", "no_mask", "int8_dots_only")

# a kernel mode against its twin on the same bf16 inputs (``probe_error``):
# out relative to max |twin|, within EXACT_TOL for the exact modes (K10's
# check) and DEFINED_TOL for the defined ones, which round unnormalised
# sums to bf16; lse within LSE_TOL, absolute for the exact modes and
# relative to max(1, |lse|) for the defined ones (their scores reach 1e4)
EXACT_TOL, DEFINED_TOL, LSE_TOL = 1e-2, 2e-2, 1e-4
NO_KBD_MIN_DIFF = 1e-1   # no_kbd's out differs from kernel's by more

launches = 0       # wrapper calls that ran a bf16 probe mode
launches_int8 = 0  # wrapper calls that ran an int8 probe mode


def is_int8(variant: str) -> bool:
    return PROBE_VARIANTS[variant] >= INT8_FULL


def slab_ends(t: int, p: int, device=None):
    """[T]: the end of the keys query i may see, (i // P + 1) * P."""
    i = torch.arange(t, device=device)
    return torch.clamp((i // p + 1) * p, max=t)


def visit_ends(t: int, p: int, device=None):
    """[T]: the end of the keys the forward visits for query i, unmasked:
    its 64-row warpgroup walks whole 64-key tiles up to its last row's
    slab end (K1's ``nkw``). Equal to ``slab_ends`` where P % 64 == 0."""
    first = torch.arange(t, device=device) // WG_ROWS * WG_ROWS
    kend = torch.clamp(((first + WG_ROWS - 1) // p + 1) * p, max=t)
    return torch.clamp((kend + BK - 1) // BK * BK, max=t)


def visited_tiles(t: int, p: int) -> int:
    """64-key tiles the forward's warpgroups visit over T rows, per (batch,
    head): each warpgroup does one QK and one PV product of 2 * 64 * 64 * D
    operations per tile."""
    ends = visit_ends(t, p)[::WG_ROWS]
    return int(((ends + BK - 1) // BK).sum())


def _identity_tables(t: int, d: int, device):
    return (torch.ones(t, d, device=device),
            torch.zeros(t, d, device=device))


def kernel_ref(q, k, v, *, n_heads: int, tok_per_time: int):
    """Twin of ``kernel`` / ``bf16`` / ``mask_last``, ``mask_all`` and
    ``exp2`` (the same function, exact within rounding): K1's twin with the
    identity rotation (cos 1, sin 0, which leaves q and k as they are)."""
    cos, sin = _identity_tables(q.shape[1], q.shape[2] // n_heads, q.device)
    return k1.slab_rope_attention_ref(q, k, v, cos, sin, n_heads=n_heads,
                                      tok_per_time=tok_per_time)


def int8_full_ref(q, k, v, *, n_heads: int, tok_per_time: int):
    """Twin of ``int8_full``: K10's twin with the identity rotation."""
    cos, sin = _identity_tables(q.shape[1], q.shape[2] // n_heads, q.device)
    return k1.slab_rope_attention_int8_ref(q, k, v, cos, sin, n_heads=n_heads,
                                           tok_per_time=tok_per_time)


def _probe_ref(q, k, v, n_heads: int, ends, dots, softmax: bool,
               rows: int = 256):
    """Query i attends to keys below ``ends[i]`` with scores
    ``dots(r0, r1, kmax)`` ([B, H, rows, keys] in the accumulation dtype):
    a softmax, p rounded to v's dtype before AV (as the forwards' bf16
    A-fragments), or with ``softmax=False`` the scores themselves rounded
    to v's dtype and lse 0. ``rows`` queries at a time (no T x T matrix)."""
    b, t, e = q.shape
    d = e // n_heads
    acc = torch.promote_types(q.dtype, torch.float32)
    vf = v.reshape(b, t, n_heads, d).to(acc)
    out = torch.empty(b, t, n_heads, d, dtype=q.dtype, device=q.device)
    lse = torch.zeros(b, n_heads, t, dtype=acc, device=q.device)
    for r0 in range(0, t, rows):
        r1 = min(t, r0 + rows)
        kmax = int(ends[r1 - 1])
        seen = (torch.arange(kmax, device=q.device)[None, :]
                < ends[r0:r1, None])                          # [rows, keys]
        s = dots(r0, r1, kmax)
        if softmax:
            s = s.masked_fill(~seen, float("-inf"))
            lse[:, :, r0:r1] = torch.logsumexp(s, dim=-1)
            a = torch.softmax(s, dim=-1)
        else:
            a = s.masked_fill(~seen, 0.0)
        a = a.to(v.dtype).to(acc)
        out[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", a,
                                     vf[:, :kmax]).to(q.dtype)
    return out.reshape(b, t, e), lse


def _heads(x, n_heads: int, dtype):
    b, t, e = x.shape
    return x.reshape(b, t, n_heads, e // n_heads).to(dtype)


def _qk(qh, kh, scale):
    """dots(r0, r1, kmax) of [B, T, H, D] q and k (or their codes), each
    score times ``scale`` where it is not None."""
    def dots(r0, r1, kmax):
        s = torch.einsum("bqhd,bkhd->bhqk", qh[:, r0:r1], kh[:, :kmax])
        return s if scale is None else s * scale
    return dots


def _cast_codes(x, n_heads: int, dtype):
    """The cast-only codes round(8 x) (half to even), as floats."""
    return torch.round(_heads(x, n_heads, dtype) * 8.0)


def _absmax_qk_codes(q, k, n_heads: int, dtype):
    """K10's codes without the rotation: q per (row, head), k per (1024-row
    chunk, head) (``slab_attention._absmax_codes``), as floats."""
    qc, _ = k1._absmax_codes(_heads(q, n_heads, dtype), (3,))
    b, t, e = k.shape
    kc, _ = k1._absmax_codes(
        k.to(dtype).reshape(b, t // k1.KCHUNK, k1.KCHUNK, n_heads,
                            e // n_heads), (2, 4))
    return qc, kc.reshape(b, t, n_heads, e // n_heads)


def _scale(q, n_heads: int) -> float:
    return 1.0 / float(q.shape[2] // n_heads) ** 0.5


def no_mask_ref(q, k, v, *, n_heads: int, tok_per_time: int):
    """Twin of ``no_mask``: softmax attention over the keys the forward
    visits (``visit_ends``), no slab mask."""
    acc = torch.promote_types(q.dtype, torch.float32)
    dots = _qk(_heads(q, n_heads, acc), _heads(k, n_heads, acc),
               _scale(q, n_heads))
    return _probe_ref(q, k, v, n_heads,
                      visit_ends(q.shape[1], tok_per_time, q.device), dots,
                      True)


def dots_only_ref(q, k, v, *, n_heads: int, tok_per_time: int):
    """Twin of ``dots_only``: out_i = sum over the visited keys j of
    round(scale * q_i . k_j) v_j (round to v's dtype), no softmax; lse 0."""
    acc = torch.promote_types(q.dtype, torch.float32)
    dots = _qk(_heads(q, n_heads, acc), _heads(k, n_heads, acc),
               _scale(q, n_heads))
    return _probe_ref(q, k, v, n_heads,
                      visit_ends(q.shape[1], tok_per_time, q.device), dots,
                      False)


def int8_dots_only_ref(q, k, v, *, n_heads: int, tok_per_time: int):
    """Twin of ``int8_dots_only``: ``dots_only`` with the raw integer dots
    of the cast-only codes round(8 q), round(8 k) as scores (no scale)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    dots = _qk(_cast_codes(q, n_heads, acc), _cast_codes(k, n_heads, acc),
               None)
    return _probe_ref(q, k, v, n_heads,
                      visit_ends(q.shape[1], tok_per_time, q.device), dots,
                      False)


def int8_cheap_dequant_ref(q, k, v, *, n_heads: int, tok_per_time: int):
    """Twin of ``int8_cheap_dequant``: slab attention with scores
    dot(q8, k8) * scale on K10's codes (no s_q, s_k)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    dots = _qk(*_absmax_qk_codes(q, k, n_heads, acc), _scale(q, n_heads))
    return _probe_ref(q, k, v, n_heads,
                      slab_ends(q.shape[1], tok_per_time, q.device), dots,
                      True)


def int8_noquant_ref(q, k, v, *, n_heads: int, tok_per_time: int):
    """Twin of ``int8_noquant``: slab attention with scores
    dot(round(8 q), round(8 k)) * scale."""
    acc = torch.promote_types(q.dtype, torch.float32)
    dots = _qk(_cast_codes(q, n_heads, acc), _cast_codes(k, n_heads, acc),
               _scale(q, n_heads))
    return _probe_ref(q, k, v, n_heads,
                      slab_ends(q.shape[1], tok_per_time, q.device), dots,
                      True)


# every variant with a plain twin (all but no_kbd)
TWINS = {
    "kernel": kernel_ref, "bf16": kernel_ref, "mask_last": kernel_ref,
    "mask_all": kernel_ref, "exp2": kernel_ref, "no_mask": no_mask_ref,
    "dots_only": dots_only_ref, "int8_full": int8_full_ref,
    "int8_dots_only": int8_dots_only_ref,
    "int8_cheap_dequant": int8_cheap_dequant_ref,
    "int8_noquant": int8_noquant_ref}


def probe_error(variant: str, out, lse, ref, ref_lse) -> tuple:
    """(max |out - ref| / max |ref|, lse error): the lse error absolute for
    the exact modes and relative to max(1, |ref_lse|) for the defined
    ones."""
    out_err = float((out.float() - ref.float()).abs().max())
    lse_err = (lse.float() - ref_lse.float()).abs()
    if variant not in EXACT:
        lse_err = lse_err / ref_lse.float().abs().clamp(min=1.0)
    return (out_err / max(float(ref.float().abs().max()), 1e-30),
            float(lse_err.max()))


def agrees(variant: str, err: tuple) -> bool:
    """Whether ``probe_error``'s (out, lse) error is within the variant's
    limits."""
    return (err[0] <= (EXACT_TOL if variant in EXACT else DEFINED_TOL)
            and err[1] <= LSE_TOL)


def no_kbd_guard(out, lse, again, kernel_out) -> tuple:
    """``no_kbd``'s guard, as (finite, bitwise repeatable, max |out -
    kernel_out| over kernel_out's leading batch rows); it holds where the
    first two are true and the third is above NO_KBD_MIN_DIFF. ``again``
    is a second call's (out, lse)."""
    rows = out[:kernel_out.shape[0]]
    return (bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
            torch.equal(out, again[0]) and torch.equal(lse, again[1]),
            float((rows.float() - kernel_out.float()).abs().max()))


def guard_holds(guard: tuple) -> bool:
    return guard[0] and guard[1] and guard[2] > NO_KBD_MIN_DIFF


def supported(device, dtype, t: int, e: int, n_heads: int,
              variant: str) -> bool:
    """Whether the probe takes [B, T, E] q/k/v of ``dtype`` on ``device``
    in ``variant``: on CUDA K1's limits at head_dim 32 (bf16, T % 128 ==
    0); on the CPU any variant with a twin; and on every device T % 1024
    == 0 for the int8 modes (one K scale per 1024-row chunk)."""
    if variant not in PROBE_VARIANTS:
        return False
    if is_int8(variant) and (t <= 0 or t % k1.KCHUNK):
        return False
    if torch.device(device).type != "cuda":
        return variant in TWINS
    return (dtype == torch.bfloat16 and n_heads > 0
            and e == n_heads * HEAD_DIM and t > 0 and t % BQ == 0)


def _check(q, k, v, n_heads: int, tok_per_time: int, variant: str) -> None:
    b, t, e = q.shape
    if not supported(q.device, q.dtype, t, e, n_heads, variant):
        raise ValueError(
            f"probe {variant!r} does not take {q.dtype} [{b}, {t}, {e}] "
            f"with {n_heads} heads on {q.device} (bf16, head_dim "
            f"{HEAD_DIM}, T % {BQ} == 0, T % {k1.KCHUNK} == 0 for int8)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x is None:
            continue
        if x.dtype != q.dtype or x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{name}: need {q.dtype} {tuple(q.shape)} on "
                             f"{q.device}")
        if q.is_cuda and (not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name}: need a contiguous 16-byte-aligned "
                             "tensor")
    if tok_per_time <= 0:
        raise ValueError("tok_per_time must be positive")


def _addr(x) -> int:
    return 0 if x is None else x.data_ptr()


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_int8(q, k, v, amax, codes, out, lse, n_heads, tok_per_time,
                 variant, stages) -> None:
    """fk_slab_attention_probe_int8: ``stages`` & 1 the K pre-pass, & 2
    the Q pre-pass, & 4 the forward; ``codes`` = (q8, qs, k8, ks), those
    of a pre-pass that does not run None."""
    ref = codes[0] if codes[0] is not None else codes[2]
    b, t, e = ref.shape
    rc = build.library().fk_slab_attention_probe_int8(
        _addr(q), _addr(k), _addr(v), _addr(amax),
        *(_addr(x) for x in codes), _addr(out), _addr(lse), b, t, n_heads,
        HEAD_DIM, tok_per_time, 1.0 / HEAD_DIM ** 0.5,
        PROBE_VARIANTS[variant], stages, _stream(ref))
    build.check(rc, f"slab_attention_probe_int8[{variant}]")


def occupancy(variant: str, tok_per_time: int = 256) -> tuple:
    """(registers a thread, resident CTAs an SM) of the forward instance
    ``variant`` runs at ``tok_per_time`` (D = 32) on the current card, from
    the CUDA runtime. The int8 modes' pre-passes are K10's
    (``slab_attention.fwd_int8_occupancy("prep", ...)``)."""
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    entry = ("fk_slab_attention_probe_int8_occupancy" if is_int8(variant)
             else "fk_slab_attention_probe_occupancy")
    rc = getattr(build.library(), entry)(
        PROBE_VARIANTS[variant], tok_per_time, ctypes.byref(regs),
        ctypes.byref(ctas))
    build.check(rc, f"{entry}[{variant}]")
    return regs.value, ctas.value


def _empty_codes(x, n_heads: int, rows: int):
    """int8 codes like x and f32 scales [B, H, rows]."""
    return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
            torch.empty(x.shape[0], n_heads, rows, dtype=torch.float32,
                        device=x.device))


def _cuda_int8(x, n_heads: int, variant: str) -> None:
    if not is_int8(variant):
        raise ValueError(f"{variant!r} is not an int8 probe mode")
    if not x.is_cuda:
        raise ValueError("the probe pre-passes run on CUDA tensors only; "
                         "the twins quantize inside")
    _check(x, None, None, n_heads, 1, variant)


def probe_quantize_k(k, *, n_heads: int, variant: str):
    """An int8 mode's K pre-pass alone (CUDA tensors only): k [B, T, E] as
    stored, quantized per (1024-row chunk, head) as K10's pre-pass does, or
    cast-only (round(8 k), scales unused) for ``int8_dots_only`` and
    ``int8_noquant``. Returns (codes [B, T, E] int8, scales [B, H, T/1024]
    f32) for ``slab_attention_probe(..., with_prepass=False)``."""
    _cuda_int8(k, n_heads, variant)
    t = k.shape[1]
    k8, ks = _empty_codes(k, n_heads, t // k1.KCHUNK)
    amax = (None if variant in CAST_ONLY else
            torch.zeros(ks.shape, dtype=torch.int32, device=k.device))
    _launch_int8(None, k, None, amax, (None, None, k8, ks), None, None,
                 n_heads, 1, variant, 1)
    return k8, ks


def probe_quantize_q(q, *, n_heads: int, variant: str):
    """An int8 mode's Q pre-pass alone (CUDA tensors only): q [B, T, E] as
    stored, quantized per (row, head) as K10's Q pre-pass does, or
    cast-only as ``probe_quantize_k``. Returns (codes [B, T, E] int8,
    scales [B, H, T] f32) for ``slab_attention_probe(...,
    with_prepass=False)``."""
    _cuda_int8(q, n_heads, variant)
    q8, qs = _empty_codes(q, n_heads, q.shape[1])
    _launch_int8(q, None, None, None, (q8, qs, None, None), None, None,
                 n_heads, 1, variant, 2)
    return q8, qs


def _check_codes(pair, x, n_heads: int, rows: int, name: str) -> None:
    codes, scales = pair
    if (codes.dtype != torch.int8 or codes.shape != x.shape
            or codes.device != x.device or not codes.is_contiguous()
            or codes.data_ptr() % 16 or scales.dtype != torch.float32
            or scales.shape != (x.shape[0], n_heads, rows)
            or scales.device != x.device or not scales.is_contiguous()):
        raise ValueError(f"{name}: need probe_quantize_{name}'s (codes, "
                         "scales)")


def slab_attention_probe(q, k, v, *, n_heads: int, tok_per_time: int,
                         variant: str, with_prepass: bool = True):
    """The probe ``variant`` of slab-causal attention over UNROTATED
    [B, T, E] q, k, v (head h = columns [h*D, (h+1)*D), D = 32 on CUDA).
    Returns (out [B, T, E], lse [B, H, T] f32; lse 0 for the dots-only
    modes).

    An int8 mode runs its K and Q pre-passes, then the forward; with
    ``with_prepass=False`` it runs the forward alone, ``q`` the pair
    (codes, scales) of ``probe_quantize_q`` and ``k`` that of
    ``probe_quantize_k`` (CUDA only). CPU tensors run the mode's twin
    (``TWINS``); ``no_kbd`` has none and raises there."""
    global launches, launches_int8
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}; one of "
                         f"{sorted(PROBE_VARIANTS)}")
    int8 = is_int8(variant)
    if not v.is_cuda:
        if variant not in TWINS:
            raise ValueError(f"{variant!r} has no plain twin: its values are "
                             "wrong by design (timing only, CUDA only)")
        if not with_prepass:
            raise ValueError("with_prepass=False runs the forward alone, on "
                             "CUDA tensors only")
        _check(q, k, v, n_heads, tok_per_time, variant)
        return TWINS[variant](q, k, v, n_heads=n_heads,
                              tok_per_time=tok_per_time)
    b, t, e = v.shape
    if int8 and not with_prepass:
        _check(v, None, None, n_heads, tok_per_time, variant)
        _check_codes(q, v, n_heads, t, "q")
        _check_codes(k, v, n_heads, t // k1.KCHUNK, "k")
        codes, q, k = (*q, *k), None, None
    else:
        _check(q, k, v, n_heads, tok_per_time, variant)
    out = torch.empty_like(v)
    lse = torch.empty(b, n_heads, t, dtype=torch.float32, device=v.device)
    if not int8:
        rc = build.library().fk_slab_attention_probe(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, n_heads, HEAD_DIM, tok_per_time,
            1.0 / HEAD_DIM ** 0.5, PROBE_VARIANTS[variant], _stream(v))
        build.check(rc, f"slab_attention_probe[{variant}]")
        launches += 1
        return out, lse
    stages, amax = 4, None
    if with_prepass:
        codes = (*_empty_codes(q, n_heads, t),
                 *_empty_codes(k, n_heads, t // k1.KCHUNK))
        if variant not in CAST_ONLY:
            amax = torch.zeros(b, n_heads, t // k1.KCHUNK, dtype=torch.int32,
                               device=v.device)
        stages = 7
    _launch_int8(q, k, v, amax, codes, out, lse, n_heads, tok_per_time,
                 variant, stages)
    launches_int8 += 1
    return out, lse
