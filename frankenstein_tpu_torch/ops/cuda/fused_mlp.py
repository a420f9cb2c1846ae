"""K9: the fused pre-norm SwiGLU MLP sublayer, x + w2(silu(w1 h) * w3 h)
with h = LayerNorm(x) or RMSNorm(x), the hidden activations kept on chip.

Replaces ``frankenstein_tpu/ops/pallas/fused_mlp.py:fused_norm_swiglu``
(``_fused_call``, kernel ``_kernel``); CUDA C++ in ``csrc/fused_mlp.cu``,
whose source note says what bounds it on an H100 and how the design answers
that. ``FusedNormSwiGLU`` is the autograd Function around it: forward K9,
backward autograd through the recomputed module chain (``reference_chain``),
as the JAX package's custom VJP does.

``fused_norm_swiglu`` launches the kernel for CUDA tensors and runs the
plain PyTorch twin ``fused_norm_swiglu_ref`` for CPU tensors, never one in
place of the other: a CUDA input the kernel does not take raises.
``models/layers.py:Block`` routes its MLP sublayer here when ``ENABLED`` and
``supported`` hold, and runs the module chain otherwise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from frankenstein_tpu_torch.ops import norms
from frankenstein_tpu_torch.ops.cuda import build

# The JAX package's switch (``fused_mlp.py:45``) is off because XLA already
# fuses the chain on the TPU; eager PyTorch fuses none of it, so here it is
# on. ``chip_smoke.py`` turns it off only to time the module chain.
ENABLED = True
KINDS = {"layernorm": 0, "rmsnorm": 1}       # csrc/fused_mlp.cu
EPS = {"layernorm": 1e-5, "rmsnorm": 1e-6}   # the JAX norm_fn's
MAX_E = 256   # the widest row the kernel keeps in registers

launches = 0   # wrapper calls that ran K9


def norm_fn(x, nw, nb, kind: str):
    """``Block``'s pre-MLP norm as a function (``ops/norms.py``)."""
    if kind == "rmsnorm":
        return norms.rms_norm(x, nw, EPS["rmsnorm"])
    return norms.layer_norm(x, nw, nb, EPS["layernorm"])


def swiglu_fn(h, w1, w3, w2, dtype=None):
    """``models/layers.py:SwiGLU``'s math on nn.Linear weights ([out, in]):
    h and each weight cast to the compute dtype (the weights' own when
    None), silu and the gate in that dtype."""
    cdt = dtype or w1.dtype
    hc = h.to(cdt)
    g = F.silu(F.linear(hc, w1.to(cdt))) * F.linear(hc, w3.to(cdt))
    return F.linear(g.to(cdt), w2.to(cdt))


def reference_chain(x, nw, nb, w1, w3, w2, *, kind: str, dtype=None):
    """x + SwiGLU(norm(x)): the module chain the kernel replaces, and the
    function whose autograd is its backward."""
    h = norm_fn(x, nw, nb, kind)
    return x + swiglu_fn(h, w1, w3, w2, dtype).to(x.dtype)


def fused_norm_swiglu_ref(x, nw, nb, w1, w3, w2, *, kind: str):
    """Plain PyTorch twin of the kernel at its rounding points, with cdt =
    x's dtype: norm statistics in f32, h = cdt(f32(cdt(normed)) * nw + nb),
    a = cdt(h w1^T) and b = cdt(h w3^T) summed in f32, g =
    cdt(cdt(silu_f32(a)) * b), y = g w2^T summed in f32, out = cdt(x +
    cdt(y))."""
    cdt = x.dtype
    acc = torch.promote_types(cdt, torch.float32)
    h = norm_fn(x, nw, nb, kind).to(cdt)

    def dot(a, w):
        return (a.to(acc) @ w.to(cdt).to(acc).t()).to(cdt)

    a, b = dot(h, w1), dot(h, w3)
    g = (F.silu(a.to(acc)).to(cdt).to(acc) * b.to(acc)).to(cdt)
    return (x.to(acc) + dot(g, w2).to(acc)).to(cdt)


def supported(device, dtype, e: int, hidden: int, compute_dtype) -> bool:
    """Whether ``Block`` routes x [..., E] of ``dtype`` on ``device`` with an
    MLP of width ``hidden`` here. x's dtype must be the compute dtype, as
    the JAX gate asks (``frankenstein_tpu/models/layers.py:238-241``); on
    CUDA also the kernel's own limits: bf16, E and hidden multiples of 64,
    E <= 256. The twin takes the rest on the CPU."""
    if dtype != compute_dtype:
        return False
    if torch.device(device).type != "cuda":
        return True
    return (dtype == torch.bfloat16 and e % 64 == 0 and 0 < e <= MAX_E
            and hidden > 0 and hidden % 64 == 0)


def _need(name: str, a, dtype, shape, dev) -> None:
    if (a.dtype != dtype or tuple(a.shape) != tuple(shape)
            or not a.is_contiguous() or a.data_ptr() % 16
            or a.device != dev):
        raise ValueError(f"{name}: need a contiguous 16-byte-aligned {dtype} "
                         f"{tuple(shape)} on {dev}, got {a.dtype} "
                         f"{tuple(a.shape)} on {a.device}")


def _check(x, nw, nb, w1, w3, w2, kind: str) -> None:
    if x.dim() < 2:
        raise ValueError(f"x: need [..., E], got {tuple(x.shape)}")
    e, hidden = x.shape[-1], w1.shape[0]
    if e % 64 or e > MAX_E or hidden % 64 or hidden <= 0:
        raise ValueError(f"E={e}, hidden={hidden}: the kernel needs E and "
                         f"hidden multiples of 64 and E <= {MAX_E}")
    _need("x", x, torch.bfloat16, x.shape, x.device)
    for name, w, shape in (("w1", w1, (hidden, e)), ("w3", w3, (hidden, e)),
                           ("w2", w2, (e, hidden))):
        _need(name, w, torch.bfloat16, shape, x.device)
    _need("nw", nw, torch.float32, (e,), x.device)
    if nb is not None:
        if kind == "rmsnorm":
            raise ValueError("rmsnorm takes no bias")
        _need("nb", nb, torch.float32, (e,), x.device)


def fused_norm_swiglu(x, nw, nb, w1, w3, w2, *, kind: str = "layernorm"):
    """x [..., E] in the compute dtype -> x + w2(silu(w1 h) * w3 h), h =
    norm(x). nw, nb: the norm's [E] weight and bias (nb None for RMSNorm);
    w1, w3 [hidden, E] and w2 [E, hidden]: nn.Linear weights in any float
    dtype, cast here to x's dtype, and the norm's parameters to f32 (the
    JAX call's casts). K9 on CUDA tensors, the twin on CPU tensors."""
    global launches
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}: one of {sorted(KINDS)}")
    w1, w3, w2 = (w.to(x.dtype) for w in (w1, w3, w2))
    nw = nw.float()
    nb = None if nb is None else nb.float()
    if not x.is_cuda:
        return fused_norm_swiglu_ref(x, nw, nb, w1, w3, w2, kind=kind)
    _check(x, nw, nb, w1, w3, w2, kind)
    out = torch.empty_like(x)
    e, hidden = x.shape[-1], w1.shape[0]
    rc = build.library().fk_fused_norm_swiglu(
        x.data_ptr(), nw.data_ptr(), None if nb is None else nb.data_ptr(),
        w1.data_ptr(), w3.data_ptr(), w2.data_ptr(), out.data_ptr(),
        x.numel() // e, e, hidden, KINDS[kind], EPS[kind],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "fused_norm_swiglu")
    launches += 1
    return out


def occupancy(e: int, kind: str = "layernorm", warpgroups: int = 0,
              rows: int = 0) -> tuple:
    """(registers a thread, resident CTAs an SM) of the kernel at width
    ``e`` with 1 or 2 consumer ``warpgroups`` (0: the count a launch of
    ``rows`` rows takes), from the CUDA runtime."""
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    rc = build.library().fk_fused_norm_swiglu_occupancy(
        e, KINDS[kind], warpgroups, rows, ctypes.byref(regs),
        ctypes.byref(ctas))
    build.check(rc, f"fused_norm_swiglu_occupancy[{e}, {kind}]")
    return regs.value, ctas.value


class FusedNormSwiGLU(torch.autograd.Function):
    """out = fused_norm_swiglu(x, nw, nb, w1, w3, w2): K9 forward (its twin
    on the CPU), saving only x and the norm and weight tensors; the backward
    recomputes ``reference_chain`` and returns its autograd gradients (the
    JAX package's ``_fused_bwd``), each in its input's dtype. nb is None for
    RMSNorm."""

    @staticmethod
    def forward(ctx, x, nw, nb, w1, w3, w2, kind: str):
        ctx.kind = kind
        ctx.save_for_backward(x, nw, nb, w1, w3, w2)
        return fused_norm_swiglu(x, nw, nb, w1, w3, w2, kind=kind)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        want = [i for i, a in enumerate(saved)
                if a is not None and ctx.needs_input_grad[i]]
        leaves = [None if a is None else a.detach().requires_grad_(i in want)
                  for i, a in enumerate(saved)]
        with torch.enable_grad():
            out = reference_chain(*leaves, kind=ctx.kind,
                                  dtype=saved[0].dtype)
            grads = torch.autograd.grad(out, [leaves[i] for i in want], dy)
        result = [None] * 7
        for i, g in zip(want, grads):
            result[i] = g
        return tuple(result)
