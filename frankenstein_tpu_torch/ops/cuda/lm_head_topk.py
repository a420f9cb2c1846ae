"""K8: the decode step's head, LayerNorm(x) -> tied LM head -> top-k and the
exact full-vocab logsumexp, without the [B, V] logits in device memory.

Replaces ``frankenstein_tpu/ops/pallas/lm_head_topk.py:lm_head_topk``
(kernel ``_kernel``); CUDA C++ in ``csrc/lm_head_topk.cu``, whose source note
says what bounds it on an H100 and how the design answers that. The JAX
wrapper returns each vocab chunk's top-k and leaves the last top-k to its
caller; here the merge is part of the kernel work, so ``lm_head_topk``
returns the final top-k.

``lm_head_topk`` launches the kernels for CUDA tensors and runs the plain
PyTorch twin ``lm_head_topk_ref`` for CPU tensors, never one in place of
the other: a CUDA input the kernels do not take raises.
``models/gpt2.py:GPT.decode_step_topk`` routes here where ``supported``
holds, and runs ``ln_f`` + the dense head + ``exact_topk`` otherwise.

A decode loop calls K8 once a token at one shape, so the wrapper keeps what
the kernels need from one call to the next: the scratch (h, each CTA's
candidate lists, the grid barrier) keyed by device and shape, and the f32
copies of ln_w and ln_b keyed by the parameters' identity and version. A
repeated call allocates only its outputs (a caller may hold a step's
results while the next step runs) and casts nothing.
"""

from __future__ import annotations

import ctypes

import torch

from frankenstein_tpu_torch.ops.cuda import build

MAX_K = 32
SMEM_MAX = 232448          # bytes of shared memory a CTA may opt into

launches = 0   # wrapper calls that ran K8


def exact_topk(logits, k: int):
    """(values, indices) of the k largest entries of each row, descending,
    ties to the lowest index (a stable sort; ``torch.topk`` does not fix the
    order of ties)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def head_logits_ref(x, ln_w, ln_b, wte, eps: float = 1e-5):
    """The [B, V] logits of the kernels' arithmetic: statistics and affine
    in f32 (f64 for f64 input), h rounded to the table's dtype (the JAX
    kernel's rounding point), products summed in f32."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    h = (xf - mu) * torch.rsqrt(var + eps)
    h = (h * ln_w.to(acc) + ln_b.to(acc)).to(wte.dtype)
    return h.to(acc) @ wte.to(acc).t()


def lm_head_topk_ref(x, ln_w, ln_b, wte, *, k: int, eps: float = 1e-5):
    """Plain PyTorch twin of the kernels: ``head_logits_ref``, then
    ``exact_topk`` and ``torch.logsumexp`` over the whole vocab.

    x [B, E]; ln_w, ln_b [E]; wte [V, E]. Returns (vals [B, k] f32,
    idx [B, k] int64, logz [B] f32) (f64 values for f64 input)."""
    logits = head_logits_ref(x, ln_w, ln_b, wte, eps)
    vals, idx = exact_topk(logits, k)
    return vals, idx, torch.logsumexp(logits, dim=-1)


WIDTHS = (8, 16, 32, 64, 128)   # the kernel's batch widths N
VB = 128                  # vocab rows a block (two m64 warpgroups)
MAX_GRID = 256            # CTAs whose lists one warp merges
_MAX_STAGES = 8


def _plan(b: int, k: int, grid: int = 132):
    """(batch width N, ring stages, dynamic shared memory bytes) of the
    instance a ``b``-row call at top-``k`` runs on a grid of ``grid`` CTAs
    (``csrc/lm_head_topk.cu``: ``with_width``, ``stages``, ``Layout``), or
    None where the lists of a merged row would not fit its shared memory."""
    n = next((w for w in WIDTHS if w >= b), WIDTHS[-1])
    stage = VB * 128 + n * 128                # 64 columns of table and of h
    # the staged block, the lanes' sum-exp, the running max, the lists
    fixed = n * (VB + 4) * 4 + n * 32 * 4 + n * 4 + 8 * n * k
    st = min(_MAX_STAGES, (SMEM_MAX - 1024 - fixed) // (stage + 16))
    total = st * stage + fixed + 16 * st
    if st < 2 or total < grid * (k + k % 2) * 8:
        return None
    return n, st, total + 1024


_grids = {}


def grid_size(device, v: int) -> int:
    """CTAs of a call over a V-row table: one an SM, at most one a vocab
    block and at most ``MAX_GRID``."""
    key = (str(device), v)
    if key not in _grids:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _grids[key] = max(1, min(sms, -(-v // VB), MAX_GRID))
    return _grids[key]


def supported(device, x_dtype, w_dtype, b: int, e: int, v: int,
              k: int) -> bool:
    """Whether K8 takes x [B, E] of ``x_dtype`` and a [V, E] table of
    ``w_dtype`` on ``device`` for a top-``k``: on CUDA bf16 both, E % 8 ==
    0 (the table is streamed, so any width), 1 <= k <= MAX_K and k <= V
    (any B, any V: the vocab tail is masked); the CPU twin takes any
    input."""
    if torch.device(device).type != "cuda":
        return True
    return (x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16
            and b > 0 and e > 0 and e % 8 == 0 and 1 <= k <= min(MAX_K, v)
            and _plan(b, k, MAX_GRID) is not None)


def _check(x, ln_w, ln_b, wte, k: int) -> None:
    if x.dim() != 2 or wte.dim() != 2 or x.shape[1] != wte.shape[1]:
        raise ValueError(f"need x [B, E] and wte [V, E], got "
                         f"{tuple(x.shape)} and {tuple(wte.shape)}")
    (b, e), v = x.shape, wte.shape[0]
    if not supported(x.device, x.dtype, wte.dtype, b, e, v, k):
        raise ValueError(f"K8 takes bf16 x and table, E % 8 == 0 and "
                         f"1 <= k <= min({MAX_K}, V); got x {x.dtype} "
                         f"{tuple(x.shape)}, wte {wte.dtype} "
                         f"{tuple(wte.shape)}, k={k}")
    for name, a, dtype, shape in (("x", x, torch.bfloat16, (b, e)),
                                  ("wte", wte, torch.bfloat16, (v, e)),
                                  ("ln_w", ln_w, torch.float32, (e,)),
                                  ("ln_b", ln_b, torch.float32, (e,))):
        if (a.dtype != dtype or tuple(a.shape) != shape
                or not a.is_contiguous() or a.data_ptr() % 16
                or a.device != x.device):
            raise ValueError(f"{name}: need a contiguous 16-byte-aligned "
                             f"{dtype} {shape} on {x.device}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")


_scratch_cache = {}
_param_cache = {}
_CACHE_MAX = 16


def _scratch(device, b: int, e: int, k: int, grid: int, stream: int = 0):
    """(h [B, E] bf16, cand [B, G, KP] (key, index) pairs as int32 (KP =
    k rounded up to even), part [B, G, 2] f32, bar [64] int32 zeros) of a
    call's shape on a stream, allocated once and kept (calls on one stream
    run in turn, so they may share it)."""
    key = (str(device), stream, b, e, k, grid)
    if key not in _scratch_cache:
        if len(_scratch_cache) >= _CACHE_MAX:
            _scratch_cache.clear()
        _scratch_cache[key] = (
            torch.empty(b, e, dtype=torch.bfloat16, device=device),
            torch.empty(b, grid, k + k % 2, 2, dtype=torch.int32,
                        device=device),
            torch.empty(b, grid, 2, dtype=torch.float32, device=device),
            torch.zeros(64, dtype=torch.int32, device=device))
    return _scratch_cache[key]


def _as_f32(p, e: int, device):
    """``p`` as a contiguous f32 [E] tensor (zeros for None): ``p`` itself
    where it already is one, else a copy kept until ``p`` changes (its
    identity or in-place version; the entry holds ``p``, so its identity
    is not reused while the copy is kept)."""
    if p is not None and p.dtype == torch.float32 and p.is_contiguous():
        return p
    key = (("zeros", e, str(device)) if p is None else
           (id(p), p._version, tuple(p.shape), p.dtype, str(p.device)))
    if key not in _param_cache:
        if len(_param_cache) >= _CACHE_MAX:
            _param_cache.clear()
        _param_cache[key] = (
            p, torch.zeros(e, dtype=torch.float32, device=device) if p is None
            else p.detach().float().contiguous())
    return _param_cache[key][1]


def lm_head_topk(x, ln_w, ln_b, wte, *, k: int, eps: float = 1e-5):
    """x [B, E] pre-``ln_f`` activations; ln_w, ln_b [E] (ln_b None for a
    LayerNorm without bias), in f32 as the JAX call casts them; wte [V, E],
    the tied table as stored. Returns (vals [B, k] f32, descending; idx
    [B, k] int64; logz [B] f32, the exact full-vocab logsumexp, so vals -
    logz are exact log-probabilities). K8 on CUDA tensors, the twin on CPU
    tensors."""
    global launches
    if not x.is_cuda:
        if ln_b is None:
            ln_b = torch.zeros_like(ln_w)
        return lm_head_topk_ref(x, ln_w, ln_b, wte, k=k, eps=eps)
    (b, e), v = x.shape, wte.shape[0]
    ln_w, ln_b = _as_f32(ln_w, e, x.device), _as_f32(ln_b, e, x.device)
    _check(x, ln_w, ln_b, wte, k)
    grid = grid_size(x.device, v)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    h, cand, part, bar = _scratch(x.device, b, e, k, grid, stream)
    vals = torch.empty(b, k, dtype=torch.float32, device=x.device)
    idx = torch.empty(b, k, dtype=torch.int64, device=x.device)
    logz = torch.empty(b, dtype=torch.float32, device=x.device)
    rc = build.library().fk_lm_head_topk(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wte.data_ptr(),
        h.data_ptr(), cand.data_ptr(), part.data_ptr(), bar.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), logz.data_ptr(), b, e, v, k, grid,
        eps, stream)
    build.check(rc, "lm_head_topk")
    launches += 1
    return vals, idx, logz


INFO_FIELDS = ("width", "stages", "smem", "regs", "ctas", "local_bytes")


def info(b: int, k: int, grid: int) -> dict:
    """The launch of a ``b``-row call at top-``k`` on ``grid`` CTAs, from
    the CUDA runtime: its batch width N, ring stages, dynamic shared
    memory, registers a thread, resident CTAs an SM and local-memory bytes
    a thread (spills)."""
    out = (ctypes.c_int * len(INFO_FIELDS))()
    build.check(build.library().fk_lm_head_topk_info(b, k, grid, out),
                "lm_head_topk_info")
    return dict(zip(INFO_FIELDS, out))
