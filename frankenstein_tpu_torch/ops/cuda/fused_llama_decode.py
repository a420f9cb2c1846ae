"""K5: one LLaMA token through all transformer blocks.

Replaces ``frankenstein_tpu/ops/pallas/fused_llama_decode.py``:
``fused_llama_decode_blocks`` (the grid kernel ``_kernel``), the manually
pipelined ``_fused_llama_decode_pipelined`` and the big-model
``_fused_llama_decode_bigmodel``. Those are three TPU schedules of one
computation, chosen by VMEM budget; here one CUDA C++ kernel family
(``frankenstein_tpu_torch/csrc/fused_llama_decode.cu``) takes every
geometry, with no VMEM gate and no ``FK_LLAMA_*`` switch: K2's persistent
decode step (``csrc/decode_common.cuh``), one cooperative launch a token,
with K2's launch knobs (``fused_decode.TUNING``). Its source note says what
bounds it on an H100 and how the design answers that.

Per layer: f32 RMSNorm -> q, k, v products -> RoPE on the new q row (width
E) and k row (width E_kv) with the folded cos/sin rows of position
``length`` -> GQA attention, head h reading KV head h // (H / KV) of the
UNEXPANDED ``[L, B, S, E_kv]`` cache over rows < ``length`` plus the
token's own k and v -> o_proj + residual -> f32 RMSNorm -> SwiGLU ->
down_proj + residual. The residual stays f32 across the layers. The new
K/V rows are written IN PLACE at row ``length``.

``fused_llama_decode_blocks`` launches the kernels for CUDA tensors and
runs the plain PyTorch twin ``fused_llama_decode_blocks_ref`` for CPU
tensors, never one in place of the other. Modes: bf16 weights, or int8
w8a16 weights (``quantize_weights``), each with a bf16 cache or an int8
cache with fixed per-(layer, lane) f32 scales: the k-scale multiplies q
before it meets the codes, the v-scale multiplies the AV sum, the token's
own K/V terms stay float, and the new row is requantized in the kernel.
``supported`` says which inputs the kernels take;
``models/llama.py:Llama.decode_step`` consults it and runs the module blocks
where it says no.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from frankenstein_tpu_torch.ops.cuda import build
from frankenstein_tpu_torch.ops.cuda import fused_decode as k2

launches = 0          # wrapper calls that ran the CUDA kernels (one per
                      # token step), in either cache mode
launches_int8_kv = 0  # the same, counting only the int8-KV mode

WEIGHT_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
MAX_HEAD_DIM = 128
MAX_SMEM = 227 * 1024      # shared memory one H100 block may opt in to
ATTN_ROWS = 64             # cache rows of an attention tile (decode_common.cuh)


def quantize_weights(stacked: dict) -> dict:
    """w8a16: int8 matrices with per-(layer, out-lane) scales.

    Each weight [L, in, out] becomes int8 codes ``clip(round(w / s), -127,
    127)`` with ``s = max(absmax_in, 1e-8) / 127`` stored as ``<key>_s``
    [L, 1, out] f32 — the JAX package's ``quantize_weights`` (round half to
    even). Other entries are kept as they are."""
    out = dict(stacked)
    for key in WEIGHT_KEYS:
        w = stacked[key].float()
        absmax = w.abs().amax(dim=1)
        s = (torch.clamp(absmax, min=1e-8) / 127.0)[:, None, :]
        out[key] = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        out[key + "_s"] = s
    return out


def compute_dtype(stacked: dict, k_cache) -> torch.dtype:
    """The JAX kernel's compute dtype: the weights' dtype, or for int8
    weights the cache's dtype (bf16 when the cache is int8 too)."""
    if stacked["wq"].dtype != torch.int8:
        return stacked["wq"].dtype
    return torch.bfloat16 if k_cache.dtype == torch.int8 else k_cache.dtype


def _rms_f32(x, w, eps: float):
    """RMSNorm all in f32 (the kernel's ``_rms_f32``; not the module path's
    ``rms_norm``, which rounds before the weight)."""
    xf = x.float()
    return xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                            + eps) * w.float()


def _rotate(x, cos, sin):
    """Adjacent-pair rotation of f32 [B, W] rows with [1, W] f32 tables:
    out[2i] = x[2i] c - x[2i+1] s, out[2i+1] = x[2i+1] c + x[2i] s."""
    pairs = x.unflatten(-1, (-1, 2))
    swapped = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return x * cos + swapped * sin


def _codes(values, scales):
    """int8 codes ``clip(round(values / scales), -127, 127)``, rounding half
    to even as ``jnp.round`` does."""
    return torch.clamp(torch.round(values.float() / scales), -127,
                       127).to(torch.int8)


def fused_llama_decode_blocks_ref(x, stacked, k_cache, v_cache, length: int,
                                  cos_row, sin_row, k_scale=None,
                                  v_scale=None, *, n_heads: int,
                                  n_kv_heads: int, eps: float,
                                  new_rows: Optional[list] = None):
    """Plain PyTorch twin of the kernels, following the JAX ``_layer_math``
    step by step: f32 residual, ``_rms_f32``, products of compute-dtype
    operands accumulated in f32 (times the w8 scale right after each), RoPE
    in f32, GQA by ``repeat_interleave`` of the KV heads. q (times
    ``k_scale`` with an int8 cache) rounds to the compute dtype before it
    meets the cache, and each q * k product rounds to it before the f32
    score sum; the probabilities round to it before the AV product, whose
    products stay f32. With an int8 cache the AV sum is multiplied by
    ``v_scale`` and the new rows are the codes of the float K/V. The
    token's own K/V terms stay float. Writes the new rows at row
    ``length`` IN PLACE and returns (x_out, k_cache, v_cache).
    ``new_rows``: a list that receives each layer's f32 (k_new, v_new)
    before they are cast or quantized."""
    w8 = stacked["wq"].dtype == torch.int8
    quant = k_cache.dtype == torch.int8
    cdt = compute_dtype(stacked, k_cache)
    n_layers = stacked["wq"].shape[0]
    b, e = x.shape
    e_kv = k_cache.shape[-1]
    d = e // n_heads
    rfac = n_heads // n_kv_heads
    scale = 1.0 / math.sqrt(d)
    to_c = lambda a: a.to(cdt).float()
    heads = lambda a: a.reshape(b, n_heads, d)
    # a kv-width [.., E_kv] tensor read by every q head of its group
    expand = lambda a: a.reshape(*a.shape[:-1], n_kv_heads, d) \
        .repeat_interleave(rfac, dim=-2)
    cos, sin = cos_row.float(), sin_row.float()

    def dot(a, key, l):
        y = to_c(a) @ to_c(stacked[key][l])
        return y * stacked[key + "_s"][l] if w8 else y

    xf = x.float()
    for l in range(n_layers):
        h = _rms_f32(xf, stacked["norm1_w"][l], eps)
        q = _rotate(dot(h, "wq", l), cos, sin)
        k_new = _rotate(dot(h, "wk", l), cos[:, :e_kv], sin[:, :e_kv])
        v_new = dot(h, "wv", l)
        kc = expand(to_c(k_cache[l, :, :length]))         # [B, T, H, D]
        vc = expand(to_c(v_cache[l, :, :length]))
        q_k = q * expand(k_scale[l]).reshape(1, e) if quant else q
        # each q * k product rounds to the compute dtype before its f32 sum
        # (in the JAX kernel the elementwise product feeds a dot); the p * v
        # products stay f32 (there the widening fuses into the product)
        s = to_c(heads(to_c(q_k))[:, None] * kc).sum(-1) \
            .transpose(1, 2) * scale                          # [B, H, T]
        s_own = (heads(q) * expand(k_new)).sum(-1) * scale    # [B, H]
        m = s_own if length == 0 else torch.maximum(s.amax(-1), s_own)
        p = torch.exp(s - m[..., None])
        p_own = torch.exp(s_own - m)
        denom = p.sum(-1) + p_own
        p = to_c(p / denom[..., None]).transpose(1, 2)        # [B, T, H]
        o = torch.einsum("bjh,bjhd->bhd", p, vc)              # [B, H, D]
        if quant:
            o = o * expand(v_scale[l]).reshape(1, n_heads, d)
        o = (o + (p_own / denom)[..., None] * expand(v_new)).reshape(b, e)
        xf = xf + dot(o, "wo", l)
        h2 = _rms_f32(xf, stacked["norm2_w"][l], eps)
        g, u = dot(h2, "wg", l), dot(h2, "wu", l)
        xf = xf + dot(g * torch.sigmoid(g) * u, "wd", l)
        if new_rows is not None:
            new_rows.append((k_new, v_new))
        if quant:
            k_cache[l, :, length] = _codes(k_new, k_scale[l])
            v_cache[l, :, length] = _codes(v_new, v_scale[l])
        else:
            k_cache[l, :, length] = k_new.to(k_cache.dtype)
            v_cache[l, :, length] = v_new.to(v_cache.dtype)
    return xf.to(x.dtype), k_cache, v_cache


def _need(name: str, a, dtype, shape, dev) -> None:
    if (a is None or a.dtype != dtype or tuple(a.shape) != tuple(shape)
            or not a.is_contiguous() or a.device != dev):
        got = ("None" if a is None
               else f"{a.dtype} {tuple(a.shape)} on {a.device}")
        raise ValueError(f"{name}: need contiguous {dtype} {tuple(shape)} on "
                         f"{dev}, got {got}")


def attention_smem_bytes(d: int, r: int, s: int, cache_bytes: int) -> int:
    """The attention working set of one (batch row, KV head) item for
    head_dim ``d``, ``r`` query heads per KV head and a cache of ``s`` rows
    of ``cache_bytes``-byte values: ``fk_fused_llama_decode_smem_bytes`` of
    ``csrc/fused_llama_decode.cu``, which ``_check`` asks the library for."""
    return ((3 * r * d + 2 * d + r * s + 2 * r + 3) & ~3) * 4 \
        + ATTN_ROWS * d * cache_bytes


def supported(device, dtype, w_dtype, cache_dtype, e: int, n_heads: int,
              n_kv_heads: int, f: int, s: int) -> bool:
    """Whether K5 takes a step of x [B, E] of ``dtype``, stacked weights of
    ``w_dtype`` and an [L, B, S, E_kv] cache of ``cache_dtype`` on
    ``device``: on CUDA bf16 x, bf16 or int8 weights and cache, H % KV ==
    0, a head_dim that is a multiple of 8 (16 with an int8 cache) and at
    most 128, E and F multiples of 128, E_kv a multiple of 64 and the
    scores of S rows within a block's shared memory (the limits ``_check``
    raises on); the CPU twin takes any."""
    if torch.device(device).type != "cuda":
        return True
    pair = (torch.bfloat16, torch.int8)
    if (dtype != torch.bfloat16 or w_dtype not in pair
            or cache_dtype not in pair or n_heads <= 0 or n_kv_heads <= 0
            or n_heads % n_kv_heads or e % n_heads):
        return False
    d = e // n_heads
    step = 16 if cache_dtype == torch.int8 else 8
    cache_bytes = 1 if cache_dtype == torch.int8 else 2
    return (d % step == 0 and d <= MAX_HEAD_DIM and e % 128 == 0
            and f % 128 == 0 and (n_kv_heads * d) % 64 == 0
            and attention_smem_bytes(d, n_heads // n_kv_heads, s,
                                     cache_bytes) <= MAX_SMEM)


def _check(x, stacked, k_cache, v_cache, length: int, cos_row, sin_row,
           k_scale, v_scale, n_heads: int, n_kv_heads: int) -> None:
    dev = x.device
    b, e = x.shape
    n_layers, _, s, e_kv = k_cache.shape
    quant = k_cache.dtype == torch.int8
    w8 = stacked["wq"].dtype == torch.int8
    _need("x", x, torch.bfloat16, (b, e), dev)
    if k_cache.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"k_cache: need bf16 or int8, got {k_cache.dtype}")
    _need("k_cache", k_cache, k_cache.dtype, (n_layers, b, s, e_kv), dev)
    _need("v_cache", v_cache, k_cache.dtype, (n_layers, b, s, e_kv), dev)
    if n_heads <= 0 or n_kv_heads <= 0 or n_heads % n_kv_heads \
            or e % n_heads:
        raise ValueError(f"n_heads={n_heads}, n_kv_heads={n_kv_heads}, E={e}:"
                         " need H % KV == 0 and E % H == 0")
    d = e // n_heads
    step = 16 if quant else 8       # 16-byte row loads of the cache
    if d % step or d > MAX_HEAD_DIM or e_kv != n_kv_heads * d:
        raise ValueError(f"head_dim {d}, E_kv {e_kv}: the kernel needs a "
                         f"head_dim that is a multiple of {step}, at most "
                         f"{MAX_HEAD_DIM}, and E_kv = KV * head_dim")
    f = stacked["wg"].shape[-1]
    if e % 128 or f % 128 or e_kv % 64:
        raise ValueError(f"E={e}, E_kv={e_kv}, F={f}: the products need E "
                         "and F multiples of 128 and E_kv a multiple of 64")
    if not 0 <= length < s:
        raise ValueError(f"length {length} outside the cache [0, {s})")
    smem = build.library().fk_fused_llama_decode_smem_bytes(
        d, n_heads // n_kv_heads, s, k_cache.element_size())
    if smem > MAX_SMEM:
        raise ValueError(f"S={s} with {n_heads // n_kv_heads} query heads per"
                         f" KV head needs {smem} bytes of shared memory for "
                         f"the scores, over the {MAX_SMEM} a block has")
    for name, row in (("cos_row", cos_row), ("sin_row", sin_row)):
        _need(name, row, torch.float32, (1, e), dev)
    if quant:
        _need("k_scale", k_scale, torch.float32, (n_layers, 1, e_kv), dev)
        _need("v_scale", v_scale, torch.float32, (n_layers, 1, e_kv), dev)
    shapes = {"wq": (e, e), "wk": (e, e_kv), "wv": (e, e_kv), "wo": (e, e),
              "wg": (e, f), "wu": (e, f), "wd": (f, e)}
    for key, (i, o) in shapes.items():
        _need(f"stacked[{key!r}]", stacked[key],
              torch.int8 if w8 else torch.bfloat16, (n_layers, i, o), dev)
        if w8:
            _need(f"stacked[{key + '_s'!r}]", stacked[key + "_s"],
                  torch.float32, (n_layers, 1, o), dev)
    for key in ("norm1_w", "norm2_w"):
        _need(f"stacked[{key!r}]", stacked[key], torch.float32,
              (n_layers, e), dev)


def launch_info(n_layers: int, b: int, s: int, e: int, n_heads: int,
                n_kv_heads: int, f: int, w8: bool, int8: bool) -> dict:
    """How K5 launches for these shapes under ``fused_decode.TUNING``
    (``fused_decode.launch_info``'s keys)."""
    import ctypes
    out = (ctypes.c_int * 12)()
    rc = build.library().fk_fused_llama_decode_info(
        n_layers, b, s, e, n_heads, n_kv_heads, f, int(w8), int(int8),
        *k2.knob_values(), out)
    build.check(rc, "fused_llama_decode_info")
    return k2.info_dict(out)


def fused_llama_decode_blocks(x, stacked, k_cache, v_cache, length: int,
                              cos_row, sin_row, k_scale=None, v_scale=None,
                              *, n_heads: int, n_kv_heads: int, eps: float):
    """Run all LLaMA blocks for ONE token position.

    x: [B, E] embedded token; stacked: dict of [L, ...] tensors from
    ``models.llama.stack_decode_weights`` (optionally through
    ``quantize_weights``), built once per predictor: ``norm1_w``,
    ``norm2_w`` [L, E] f32 and ``wq wk wv wo wg wu wd`` [L, in, out];
    k_cache/v_cache: [L, B, S, E_kv], bf16 or int8 codes, KV heads
    unexpanded; k_scale/v_scale: the int8 caches' [L, 1, E_kv] f32 scales,
    None for a float cache; cos_row/sin_row: [1, E] f32 folded RoPE rows of
    position ``length`` (``ops/rope.py:folded_tables``); length: the
    number of valid cache rows (a host int).

    Returns (x_out [B, E], k_cache, v_cache). The caches are updated IN
    PLACE: the new K/V rows are written at row ``length`` and the returned
    caches are the same tensors."""
    global launches, launches_int8_kv
    quant = k_cache.dtype == torch.int8
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale go with an int8 cache, and "
                         "only with one")
    length = int(length)
    if not x.is_cuda:
        return fused_llama_decode_blocks_ref(
            x, stacked, k_cache, v_cache, length, cos_row, sin_row, k_scale,
            v_scale, n_heads=n_heads, n_kv_heads=n_kv_heads, eps=eps)
    _check(x, stacked, k_cache, v_cache, length, cos_row, sin_row, k_scale,
           v_scale, n_heads, n_kv_heads)
    n_layers, b, s, e_kv = k_cache.shape
    e = x.shape[1]
    f = stacked["wg"].shape[-1]
    w8 = stacked["wq"].dtype == torch.int8
    dev = x.device
    lib = build.library()
    knobs = k2.knob_values()
    x_out = torch.empty_like(x)
    workspace = k2.scratch(lib.fk_fused_llama_decode_workspace_bytes(
        n_layers, b, s, e, n_heads, n_kv_heads, f, knobs[2], knobs[3],
        knobs[0]), dev)
    p = lambda key: stacked[key].data_ptr()
    scales = [p(key + "_s") if w8 else None for key in WEIGHT_KEYS]
    rc = lib.fk_fused_llama_decode_blocks(
        x.data_ptr(), x_out.data_ptr(), workspace.data_ptr(),
        k2.barrier(dev).data_ptr(), k2.stamps_ptr(dev), cos_row.data_ptr(),
        sin_row.data_ptr(), p("norm1_w"), p("norm2_w"),
        *[p(key) for key in WEIGHT_KEYS], *scales,
        k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        n_layers, b, s, e, n_heads, n_kv_heads, f, length, float(eps),
        int(w8), int(quant), *knobs,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "fused_llama_decode_blocks")
    launches += 1
    launches_int8_kv += int(quant)
    return x_out, k_cache, v_cache
