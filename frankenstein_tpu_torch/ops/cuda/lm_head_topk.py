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
"""

from __future__ import annotations

import torch

from frankenstein_tpu_torch.ops.cuda import build

MAX_K = 32
SMEM_MAX = 232448          # bytes of shared memory a CTA may opt into
_BT = 16                   # batch rows per mma tile (csrc/lm_head_topk.cu)
_VT = 128                  # vocab rows per CTA, the same file's slab

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


def _plan(e: int, v: int, k: int):
    """The number of 128-row vocab slabs the kernels run, or None where a
    slab with a batch tile of h and its logits does not fit a CTA's shared
    memory (E > 768) or the merge's n_tiles * k candidates do not (the
    sizes ``csrc/lm_head_topk.cu`` allocates)."""
    e16 = -(-e // 16) * 16
    n_tiles = -(-v // _VT)
    if ((_VT + _BT) * (e16 + 8) * 2 + _BT * (_VT + 4) * 4 <= SMEM_MAX
            and n_tiles * k * 8 <= SMEM_MAX - 1024):
        return n_tiles
    return None


def supported(device, x_dtype, w_dtype, b: int, e: int, v: int,
              k: int) -> bool:
    """Whether K8 takes x [B, E] of ``x_dtype`` and a [V, E] table of
    ``w_dtype`` on ``device`` for a top-``k``: on CUDA bf16 both, E % 8 ==
    0 and E <= 768 (a slab that fits shared memory), 1 <= k <= MAX_K and
    k <= V (any B, any V: the vocab tail is masked); the CPU twin takes any
    input."""
    if torch.device(device).type != "cuda":
        return True
    return (x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16
            and b > 0 and e > 0 and e % 8 == 0 and 1 <= k <= min(MAX_K, v)
            and _plan(e, v, k) is not None)


def _check(x, ln_w, ln_b, wte, k: int) -> None:
    if x.dim() != 2 or wte.dim() != 2 or x.shape[1] != wte.shape[1]:
        raise ValueError(f"need x [B, E] and wte [V, E], got "
                         f"{tuple(x.shape)} and {tuple(wte.shape)}")
    (b, e), v = x.shape, wte.shape[0]
    if not supported(x.device, x.dtype, wte.dtype, b, e, v, k):
        raise ValueError(f"K8 takes bf16 x and table, E % 8 == 0, E <= 768 "
                         f"and 1 <= k <= min({MAX_K}, V); got x {x.dtype} "
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


def lm_head_topk(x, ln_w, ln_b, wte, *, k: int, eps: float = 1e-5):
    """x [B, E] pre-``ln_f`` activations; ln_w, ln_b [E] (ln_b None for a
    LayerNorm without bias), cast here to f32 as the JAX call does; wte
    [V, E], the tied table as stored. Returns (vals [B, k] f32, descending;
    idx [B, k] int64; logz [B] f32, the exact full-vocab logsumexp, so
    vals - logz are exact log-probabilities). K8 on CUDA tensors, the twin
    on CPU tensors."""
    global launches
    if ln_b is None:
        ln_b = torch.zeros_like(ln_w)
    if not x.is_cuda:
        return lm_head_topk_ref(x, ln_w, ln_b, wte, k=k, eps=eps)
    ln_w, ln_b = ln_w.float().contiguous(), ln_b.float().contiguous()
    _check(x, ln_w, ln_b, wte, k)
    (b, e), v = x.shape, wte.shape[0]
    n_tiles = _plan(e, v, k)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    h = torch.empty(-(-b // _BT) * _BT, -(-e // 16) * 16,
                    dtype=torch.bfloat16, device=dev)
    cand_val = torch.empty(b, n_tiles, k, **f32)
    cand_idx = torch.empty(b, n_tiles, k, dtype=torch.int32, device=dev)
    tile_m, tile_se = (torch.empty(b, n_tiles, **f32) for _ in range(2))
    vals = torch.empty(b, k, **f32)
    idx = torch.empty(b, k, dtype=torch.int64, device=dev)
    logz = torch.empty(b, **f32)
    rc = build.library().fk_lm_head_topk(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wte.data_ptr(),
        h.data_ptr(), cand_val.data_ptr(), cand_idx.data_ptr(),
        tile_m.data_ptr(), tile_se.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), logz.data_ptr(), b, e, v, k, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "lm_head_topk")
    launches += 1
    return vals, idx, logz
