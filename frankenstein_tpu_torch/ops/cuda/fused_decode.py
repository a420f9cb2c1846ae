"""K2: one GPT-2 token through all transformer blocks.

Replaces ``frankenstein_tpu/ops/pallas/fused_decode.py:fused_decode_blocks``.
The kernel is CUDA C++ in ``frankenstein_tpu_torch/csrc/fused_decode.cu`` on
the persistent decode step of ``csrc/decode_common.cuh`` (shared with K5):
one cooperative launch a token runs all layers, its phases behind grid
barriers, a producer warp a CTA streaming the weight tiles and cache rows by
TMA, the products on wgmma with the batch rows as N; its source note says
what bounds it on an H100 and how the design answers that.

``fused_decode_blocks`` launches the kernel for CUDA tensors and runs the
plain PyTorch twin ``fused_decode_blocks_ref`` for CPU tensors, never one in
place of the other. Modes: bf16 weights, or int8 w8a16 weights
(``quantize_weights``), each with a bf16 cache or an int8 cache with fixed
per-(layer, lane) f32 scales (``quantize_cache_side``): the k-scale folds
into q, the v-scale multiplies the AV sum, the token's own K/V terms stay
float, and the new row is requantized in the kernel. ``supported`` says
which inputs the kernel takes; ``models/gpt2.py:GPT.decode_step`` consults
it and runs the module blocks where it says no.

``TUNING`` holds the launch knobs of both decode kernels (K2 and K5), read
on every call: CTAs an SM, ring slots, the work-item target that sets each
product's depth splits, and the N chunk (batch rows a product takes at
once). ``tools/decode_sweep.py`` holds them against their neighbours.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from frankenstein_tpu_torch.ops.cuda import build

launches = 0          # wrapper calls that ran the CUDA kernels (one per
                      # token step), in either cache mode
launches_int8_kv = 0  # the same, counting only the int8-KV mode
launches_multi_chunk = 0  # the same, counting only batches of more than
                          # one N chunk (TUNING's n_chunk rows), whose
                          # products run in several chunks of items

# the production setting, from tools/decode_sweep.py on an H100 (PERF.md)
TUNING = {"ctas_per_sm": 2, "ring": 4, "items": 264, "n_chunk": 32}
STAMPS = None   # None, or a CUDA int64 tensor of at least [grid,
                # STAMP_SLOTS] that each call fills with every CTA's ns in
                # STAMP_NAMES (chip_smoke.py's phase split)
STAMP_SLOTS = 8   # STAMPS of csrc/decode_common.cuh
STAMP_NAMES = ("products", "attention", "rows_act", "barrier_wait",
               "attention_qkv", "attention_scores", "attention_softmax_av",
               "attention_out")

WEIGHT_KEYS = ("qkv_w", "proj_w", "fc_w", "fc2_w")
SCALE_KEYS = ("qkv_s", "proj_s", "fc_s", "fc2_s")


def quantize_weights(stacked: dict) -> dict:
    """w8a16: int8 matrices with per-(layer, out-lane) scales.

    Each ``*_w`` [L, in, out] becomes int8 codes
    ``clip(round(w / s), -127, 127)`` with ``s = max(absmax_in, 1e-8) / 127``
    stored as ``*_s`` [L, 1, out] f32 — the rounding of the JAX package's
    ``quantize_weights`` (round half to even)."""
    out = dict(stacked)
    for key in WEIGHT_KEYS:
        w = stacked[key].float()
        absmax = w.abs().amax(dim=1)
        s = (torch.clamp(absmax, min=1e-8) / 127.0)[:, None, :]
        out[key] = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        out[key[:-1] + "s"] = s
    return out


def _codes(values, scales):
    """int8 codes ``clip(round(values / scales), -127, 127)``, rounding half
    to even as ``jnp.round`` does."""
    return torch.clamp(torch.round(values.float() / scales), -127,
                       127).to(torch.int8)


def quantize_cache_side(cache):
    """[L, B, S, E] float -> (int8 codes, f32 scales [L, 1, E]): symmetric
    per-(layer, lane) scales ``max(absmax over (batch, position), 1e-6) /
    127``, fixed from then on (decode steps reuse them and clip). Under
    ``parallel.mesh.batch_shard`` the absmax is the global batch's."""
    from frankenstein_tpu_torch.parallel import mesh as mesh_lib
    c = cache.float()
    absmax = mesh_lib.global_max(c.abs().amax(dim=(1, 2)))
    scales = (torch.clamp(absmax, min=1e-6) / 127.0)[:, None, :]
    return _codes(c, scales[:, :, None, :]), scales


def quantize_rows(rows, scales):
    """New K/V rows [L, B, E] -> int8 with the cache's fixed scales."""
    return _codes(rows, scales)


def quantize_with_scales(cache, scales):
    """Full cache [L, B, S, E] -> int8 with fixed scales [L, 1, E]; values
    from ``dequantize_cache_side`` round-trip to their codes."""
    return _codes(cache, scales[:, :, None, :])


def dequantize_cache_side(codes, scales, dtype):
    """Inverse of ``quantize_cache_side``."""
    return (codes.float() * scales[:, :, None, :]).to(dtype)


def _layer_norm_f32(x, w, b, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _gelu_exact(x):
    return 0.5 * x * (1.0 + torch.special.erf(x * (1.0 / math.sqrt(2.0))))


def _compute_dtype(stacked, k_cache):
    """The JAX kernel's compute dtype: the weights' dtype, or for int8
    weights the cache's dtype (bf16 when the cache is int8 too)."""
    if stacked["qkv_w"].dtype != torch.int8:
        return stacked["qkv_w"].dtype
    return torch.bfloat16 if k_cache.dtype == torch.int8 else k_cache.dtype


def fused_decode_blocks_ref(x, stacked, k_cache, v_cache, length: int,
                            k_scale=None, v_scale=None, *, n_head: int,
                            new_rows: Optional[list] = None):
    """Plain PyTorch twin of the kernels, following the JAX ``_chunk_math``:
    f32 residual across layers, f32 LayerNorm, every product accumulated in
    f32 from compute-dtype operands, exact-erf GELU. With an int8 cache the
    scaled q ``q * k_scale`` rounds to the compute dtype before it meets the
    codes, the AV sum is multiplied by ``v_scale``, and the new rows are
    ``quantize_rows`` of the float K/V. Writes the new K/V rows at row
    ``length`` of the caches IN PLACE and returns (x_out, k_cache, v_cache).
    ``new_rows``: a list that receives each layer's f32 (k_new, v_new)
    before they are cast or quantized."""
    w8 = stacked["qkv_w"].dtype == torch.int8
    quant = k_cache.dtype == torch.int8
    cdt = _compute_dtype(stacked, k_cache)
    n_layer = stacked["qkv_w"].shape[0]
    b, e = x.shape
    d = e // n_head
    scale = 1.0 / math.sqrt(d)
    to_c = lambda a: a.to(cdt).float()

    def dot(a, key, l):
        y = to_c(a) @ to_c(stacked[key][l])
        return y * stacked[key[:-1] + "s"][l] if w8 else y

    xf = x.float()
    for l in range(n_layer):
        vec = lambda key: stacked[key][l].float()
        h = _layer_norm_f32(xf, vec("ln1_w"), vec("ln1_b"))
        qkv = dot(h, "qkv_w", l) + vec("qkv_b")
        q, k_new, v_new = qkv.split(e, dim=-1)
        kc = to_c(k_cache[l, :, :length]).reshape(b, length, n_head, d)
        vc = to_c(v_cache[l, :, :length]).reshape(b, length, n_head, d)
        q_k = q * k_scale[l] if quant else q
        s = torch.einsum("bhd,bjhd->bhj", to_c(q_k).reshape(b, n_head, d),
                         kc) * scale
        s_own = (q * k_new).reshape(b, n_head, d).sum(-1) * scale
        m = s_own if length == 0 else torch.maximum(s.amax(-1), s_own)
        p = torch.exp(s - m[..., None])
        p_own = torch.exp(s_own - m)
        denom = p.sum(-1) + p_own
        p = to_c(p / denom[..., None])
        o = torch.einsum("bhj,bjhd->bhd", p, vc).reshape(b, e)
        if quant:
            o = o * v_scale[l]
        o = o + ((p_own / denom)[..., None]
                 * v_new.reshape(b, n_head, d)).reshape(b, e)
        xf = (xf + dot(o, "proj_w", l)) + vec("proj_b")
        h2 = _layer_norm_f32(xf, vec("ln2_w"), vec("ln2_b"))
        hh = _gelu_exact(dot(h2, "fc_w", l) + vec("fc_b"))
        xf = (xf + dot(hh, "fc2_w", l)) + vec("fc2_b")
        if new_rows is not None:
            new_rows.append((k_new, v_new))
        if quant:
            k_cache[l, :, length] = quantize_rows(k_new, k_scale[l])
            v_cache[l, :, length] = quantize_rows(v_new, v_scale[l])
        else:
            k_cache[l, :, length] = k_new.to(k_cache.dtype)
            v_cache[l, :, length] = v_new.to(v_cache.dtype)
    return xf.to(x.dtype), k_cache, v_cache


def supported(device, dtype, w_dtype, cache_dtype, e: int,
              n_head: int) -> bool:
    """Whether K2 takes a step of x [B, E] of ``dtype``, stacked weights of
    ``w_dtype`` and a cache of ``cache_dtype`` on ``device``: on CUDA bf16
    x, bf16 or int8 weights and cache, E % 128 == 0 and a head_dim that is
    a multiple of 8 (16 with an int8 cache), at most 128 (the limits
    ``_check`` raises on); the CPU twin takes any."""
    if torch.device(device).type != "cuda":
        return True
    pair = (torch.bfloat16, torch.int8)
    if (dtype != torch.bfloat16 or w_dtype not in pair
            or cache_dtype not in pair or n_head <= 0 or e % n_head):
        return False
    d = e // n_head
    step = 16 if cache_dtype == torch.int8 else 8
    return e % 128 == 0 and d % step == 0 and d <= 128


def _check(x, stacked, k_cache, v_cache, length: int, n_head: int,
           k_scale, v_scale):
    b, e = x.shape
    n_layer, _, s, _ = k_cache.shape
    dev = x.device
    quant = k_cache.dtype == torch.int8
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"x: need contiguous bf16 [B, E], got {x.dtype}")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (c.dtype not in (torch.bfloat16, torch.int8)
                or c.dtype != k_cache.dtype or c.shape != (n_layer, b, s, e)
                or not c.is_contiguous() or c.device != dev):
            raise ValueError(f"{name}: need contiguous bf16 or int8 (both "
                             f"sides alike) [{n_layer}, {b}, {s}, {e}] on "
                             f"{dev}")
    if quant:
        for name, a in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (a.dtype != torch.float32 or a.shape != (n_layer, 1, e)
                    or not a.is_contiguous() or a.device != dev):
                raise ValueError(f"{name}: need contiguous f32 "
                                 f"[{n_layer}, 1, {e}] on {dev}")
    step = 16 if quant else 8       # 16-byte row loads of the cache
    if e % 128 or e % n_head or (e // n_head) % step or e // n_head > 128:
        raise ValueError(f"E={e}, n_head={n_head}: the kernels need "
                         f"E % 128 == 0 and a head_dim that is a multiple of "
                         f"{step}, at most 128")
    if not 0 <= length < s:
        raise ValueError(f"length {length} outside the cache [0, {s})")
    w8 = stacked["qkv_w"].dtype == torch.int8
    shapes = {"ln1_w": (e,), "ln1_b": (e,), "qkv_b": (3 * e,),
              "proj_b": (e,), "ln2_w": (e,), "ln2_b": (e,),
              "fc_b": (4 * e,), "fc2_b": (e,),
              "qkv_w": (e, 3 * e), "proj_w": (e, e), "fc_w": (e, 4 * e),
              "fc2_w": (4 * e, e)}
    if w8:
        shapes.update({"qkv_s": (1, 3 * e), "proj_s": (1, e),
                       "fc_s": (1, 4 * e), "fc2_s": (1, e)})
    for key, shape in shapes.items():
        a = stacked[key]
        want = (torch.int8 if w8 else torch.bfloat16) \
            if key in WEIGHT_KEYS else torch.float32
        if (a.dtype != want or a.shape != (n_layer, *shape)
                or not a.is_contiguous() or a.device != dev):
            raise ValueError(f"stacked[{key!r}]: need contiguous {want} "
                             f"{(n_layer, *shape)} on {dev}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")


def knob_values() -> tuple:
    """TUNING as the C entry points take it: (CTAs an SM, ring slots, work
    items, N chunk)."""
    return (int(TUNING["ctas_per_sm"]), int(TUNING["ring"]),
            int(TUNING["items"]), int(TUNING["n_chunk"]))


def scratch(nbytes: int, dev) -> torch.Tensor:
    """The kernel's workspace of ``nbytes`` (-1: knobs it does not take)."""
    if nbytes < 0:
        raise ValueError(f"decode knobs {TUNING}: need 1-4 CTAs an SM, a "
                         "ring of 1-16 slots, at least one item and an N "
                         "chunk of 8, 16 or 32")
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


_barriers = {}


def barrier(dev) -> torch.Tensor:
    """The grid barrier of the decode kernels on ``dev``'s current stream:
    64 int32 (an arrival count, and a generation on its own 128-byte
    line), zeroed once and left ready by every launch, so a call is one
    device operation. One a stream: two streams never share one."""
    stream = torch.cuda.current_stream(dev)
    key = (stream.device, stream.cuda_stream)
    if key not in _barriers:
        _barriers[key] = torch.zeros(64, dtype=torch.int32, device=dev)
    return _barriers[key]


def stamps_ptr(dev):
    """STAMPS' pointer, or None when the phase split is not asked for."""
    if STAMPS is None:
        return None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if (STAMPS.dtype != torch.int64 or STAMPS.device != dev
            or STAMPS.numel() < STAMP_SLOTS * sms * knob_values()[0]):
        raise ValueError(f"STAMPS: need int64 [{sms * knob_values()[0]}, "
                         f"{STAMP_SLOTS}] "
                         f"on {dev}")
    return STAMPS.data_ptr()


INFO_KEYS = ("grid", "registers", "ctas_per_sm", "smem_bytes", "ring",
             "scores_in_smem", "local_bytes", "splits", "fold_act")


def info_dict(out) -> dict:
    """The twelve ints of an ``fk_*_decode_info`` call as a dict."""
    vals = list(out)
    return dict(zip(INFO_KEYS, vals[:7] + [vals[7:11], vals[11]]))


def launch_info(n_layer: int, b: int, s: int, e: int, n_head: int, w8: bool,
                int8: bool) -> dict:
    """How K2 launches for these shapes under TUNING: grid, registers a
    thread, resident CTAs an SM, dynamic shared bytes, ring slots, whether
    the scores sit in shared memory, local (spill) bytes a thread and the
    four products' depth splits, and whether the fc product's epilogue
    applies GELU (else an act phase does)."""
    import ctypes
    out = (ctypes.c_int * 12)()
    k = knob_values()
    rc = build.library().fk_fused_decode_info(
        n_layer, b, s, e, n_head, int(w8), int(int8), *k, out)
    build.check(rc, "fused_decode_info")
    return info_dict(out)


def fused_decode_blocks(x, stacked, k_cache, v_cache, length: int,
                        k_scale=None, v_scale=None, *, n_head: int):
    """Run all transformer blocks for ONE token position.

    x: [B, E] embedded token; stacked: dict of [L, ...] tensors from
    ``models.gpt2.stack_decode_weights`` (optionally through
    ``quantize_weights``), built once per predictor; k_cache/v_cache:
    [L, B, S, E], bf16 or int8 codes; k_scale/v_scale: the int8 caches'
    [L, 1, E] f32 scales (``quantize_cache_side``), None for a float cache;
    length: the number of valid cache rows (a host int).

    Returns (x_out [B, E], k_cache, v_cache). The caches are updated IN
    PLACE: the new K/V rows are written at row ``length`` and the returned
    caches are the same tensors."""
    global launches, launches_int8_kv, launches_multi_chunk
    quant = k_cache.dtype == torch.int8
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale go with an int8 cache, and "
                         "only with one")
    length = int(length)
    if not x.is_cuda:
        return fused_decode_blocks_ref(x, stacked, k_cache, v_cache, length,
                                       k_scale, v_scale, n_head=n_head)
    _check(x, stacked, k_cache, v_cache, length, n_head, k_scale, v_scale)
    n_layer, b, s, e = k_cache.shape
    w8 = stacked["qkv_w"].dtype == torch.int8
    dev = x.device
    lib = build.library()
    knobs = knob_values()
    x_out = torch.empty_like(x)
    workspace = scratch(lib.fk_fused_decode_workspace_bytes(
        n_layer, b, s, e, n_head, knobs[2], knobs[3], knobs[0]), dev)
    p = lambda key: stacked[key].data_ptr()
    scales = [p(k) if w8 else None for k in SCALE_KEYS]
    rc = lib.fk_fused_decode_blocks(
        x.data_ptr(), x_out.data_ptr(), workspace.data_ptr(),
        barrier(dev).data_ptr(), stamps_ptr(dev),
        p("ln1_w"), p("ln1_b"), p("qkv_w"), p("qkv_b"), p("proj_w"),
        p("proj_b"), p("ln2_w"), p("ln2_b"), p("fc_w"), p("fc_b"),
        p("fc2_w"), p("fc2_b"), *scales,
        k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        n_layer, b, s, e, n_head, length, int(w8), int(quant),
        knobs[0], knobs[1], knobs[2], knobs[3],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "fused_decode_blocks")
    launches += 1
    launches_int8_kv += int(quant)
    launches_multi_chunk += int(b > knobs[3])
    return x_out, k_cache, v_cache
