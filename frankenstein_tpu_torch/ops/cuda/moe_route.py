"""The routing of the dropless routed experts (``models/moe.py:
RoutedExperts``, LFM2-MoE) in two kernels: ``route`` (the f32 router, the
top k, the counting sort of the (row, choice) pairs by expert and the
offsets, one launch) and ``combine`` (the unsort and each row's weighted
sum of its k expert outputs, one launch).

Replaces no TPU kernel (the JAX package has no LFM2 and no dropless
layer). CUDA C++ in ``csrc/moe_route.cu``, whose source note says what
bounds the kernels on an H100 and how their design answers that.

``route`` and ``combine`` launch the kernels for CUDA tensors and run the
plain PyTorch twins ``route_ref`` and ``combine_ref`` for CPU tensors,
never one in place of the other: a CUDA input the kernels do not take
raises. On the card they take what the served LFM2 holds: h f32, the gate,
the bias and the experts' outputs bf16. The top k is ``moe.stable_topk``'s
in both: NaN first, ties to the lower expert index.

The route kernel's last group to finish is told by an arrival count,
``arrival_count()``, that its caller owns (one a ``RoutedExperts`` layer):
launches that share one must not run at the same time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from frankenstein_tpu_torch.ops.cuda import build

MAX_E = 64          # experts the route kernel takes (csrc/moe_route.cu)
MAX_K = 8           # choices a row
MAX_D = 8192        # the dim (a tile of 4 rows in shared memory)

launches = 0           # route calls that ran the CUDA kernel
combine_launches = 0   # combine calls that ran the CUDA kernel


class Routing(NamedTuple):
    chosen: torch.Tensor    # [N, k] int32: each row's experts, best first
    weights: torch.Tensor   # [N, k] f32: their weights
    ends: torch.Tensor      # [E] int32: end of each expert's sorted pairs
    rows: torch.Tensor      # [N * k] int32: each sorted pair's source row
    pos: torch.Tensor       # [N, k] int32: each pair's sorted position


def scores_ref(h, gate):
    """sigmoid(h @ gate^T) in f32: h [N, D], gate [E, D] as stored."""
    return torch.sigmoid(h.float() @ gate.float().t())


def select_ref(scores, bias, k: int, norm_topk_prob: bool = True,
               routed_scaling: float = 1.0):
    """(chosen [N, k] int32, weights [N, k] f32) from the scores [N, E]:
    the top k of ``scores + bias`` by ``moe.stable_topk`` (``bias`` [E]
    or None picks and weighs nothing), weighed by their scores over their
    sum plus 1e-6 (``norm_topk_prob``), times ``routed_scaling``."""
    from frankenstein_tpu_torch.models import moe   # moe imports this
    pick = scores if bias is None else scores + bias.float()
    chosen = moe.stable_topk(pick, k)[1]
    weights = torch.gather(scores, -1, chosen)
    if norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    if routed_scaling != 1:
        weights = weights * routed_scaling
    return chosen.int(), weights


def sort_ref(chosen, n_experts: int):
    """(ends [E] int32, rows [N * k] int32, pos [N, k] int32) of the pairs
    sorted by expert, stable in (row, choice) order."""
    n, k = chosen.shape
    experts, order = torch.sort(chosen.reshape(-1).long(), stable=True)
    ends = torch.searchsorted(
        experts, torch.arange(n_experts, device=chosen.device), right=True,
        out_int32=True)
    pos = torch.empty_like(order).index_copy_(
        0, order, torch.arange(n * k, device=chosen.device))
    return ends, (order // k).int(), pos.view(n, k).int()


def route_ref(h, gate, bias, k: int, *, norm_topk_prob: bool = True,
              routed_scaling: float = 1.0) -> Routing:
    """Plain twin of the route kernel."""
    s = scores_ref(h, gate)
    chosen, weights = select_ref(s, bias, k, norm_topk_prob, routed_scaling)
    return Routing(chosen, weights, *sort_ref(chosen, gate.shape[0]))


def combine_ref(y, weights, pos):
    """Plain twin of the combine kernel: y [N * k, D] sorted expert outputs,
    weights [N, k] f32, pos [N, k] -> [N, D] in y's dtype, each row's k
    outputs weighed by its weights in y's dtype (one batched product)."""
    n, k = pos.shape
    unsorted = y.index_select(0, pos.reshape(-1).long()).view(n, k, -1)
    return torch.bmm(weights.to(y.dtype)[:, None], unsorted)[:, 0]


_groups = {}


def arrival_count(device) -> torch.Tensor:
    """A route kernel's arrival count on ``device``: zero, and left zero
    by every launch. Make it outside any CUDA graph capture."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _plan(dev, n: int, d: int, e: int) -> tuple:
    """(the groups of rows the route kernel counts over n rows of d dims
    and e experts, the card's SMs)."""
    key = (str(dev), n, d, e)
    if key not in _groups:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _groups[key] = (build.library().fk_moe_route_groups(n, d, e, sms),
                        sms)
    return _groups[key]


def _check_route(h, gate, bias, k: int, ends_sum, arrived) -> None:
    if h.dim() != 2 or gate.dim() != 2 or h.shape[1] != gate.shape[1]:
        raise ValueError(f"need h [N, D] and gate [E, D], got "
                         f"{tuple(h.shape)} and {tuple(gate.shape)}")
    (n, d), e = h.shape, gate.shape[0]
    if (n < 1 or d % 8 or not 8 <= d <= MAX_D or not 1 <= e <= MAX_E
            or not 1 <= k <= min(e, MAX_K) or n * k >= 2 ** 31):
        raise ValueError(f"the route kernel takes N >= 1, D % 8 == 0, "
                         f"8 <= D <= {MAX_D}, 1 <= E <= {MAX_E} and "
                         f"1 <= k <= min(E, {MAX_K}); got N={n}, D={d}, "
                         f"E={e}, k={k}")
    for name, a, dtype, shape in (
            ("h", h, torch.float32, (n, d)),
            ("gate", gate, torch.bfloat16, (e, d)),
            ("bias", bias, torch.bfloat16, (e,)),
            ("ends_sum", ends_sum, torch.int64, (e,)),
            ("arrived", arrived, torch.int32, (1,))):
        if a is None and name in ("bias", "ends_sum"):
            continue
        if a is None or (
                a.dtype != dtype or tuple(a.shape) != shape
                or not a.is_contiguous() or a.device != h.device
                or (name in ("h", "gate") and a.data_ptr() % 16)):
            got = ("None" if a is None else
                   f"{a.dtype} {tuple(a.shape)} on {a.device}")
            raise ValueError(f"{name}: need a contiguous {dtype} {shape} on "
                             f"{h.device} (h and gate 16-byte aligned), got "
                             f"{got}")


def route(h, gate, bias, k: int, *, arrived=None,
          norm_topk_prob: bool = True, routed_scaling: float = 1.0,
          ends_sum=None) -> Routing:
    """h [N, D] f32, the gate's weight [E, D] and ``bias`` [E] (or None)
    -> ``Routing`` of the top ``k`` experts of each row. ``ends_sum``
    (int64 [E], or None): ``ends`` is added to it in place. The kernel on
    CUDA tensors (a bf16 gate and bias, widened exactly; ``arrived``, an
    ``arrival_count`` on h's device), the twin on CPU tensors."""
    global launches
    if not h.is_cuda:
        out = route_ref(h, gate, bias, k, norm_topk_prob=norm_topk_prob,
                        routed_scaling=routed_scaling)
        if ends_sum is not None:
            ends_sum += out.ends
        return out
    _check_route(h, gate, bias, k, ends_sum, arrived)
    (n, d), e = h.shape, gate.shape[0]
    groups, sms = _plan(h.device, n, d, e)
    # one int32 buffer: chosen, weights (as f32), pos, rows, ends, counts,
    # each 16-byte aligned
    sizes = [n * k, n * k, n * k, n * k, e, e * groups]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + -(-s // 4) * 4)
    buf = torch.empty(offs[-1], dtype=torch.int32, device=h.device)
    part = [buf[o:o + s] for o, s in zip(offs, sizes)]
    chosen, weights = part[0].view(n, k), part[1].view(torch.float32)
    pos, rows, ends, counts = part[2].view(n, k), part[3], part[4], part[5]
    null = lambda a: None if a is None else a.data_ptr()
    rc = build.library().fk_moe_route(
        h.data_ptr(), gate.data_ptr(), null(bias), chosen.data_ptr(),
        weights.data_ptr(), pos.data_ptr(), rows.data_ptr(), ends.data_ptr(),
        null(ends_sum), counts.data_ptr(), arrived.data_ptr(), n, d, e, k,
        int(norm_topk_prob), sms, float(routed_scaling),
        torch.cuda.current_stream(h.device).cuda_stream)
    build.check(rc, "moe_route")
    launches += 1
    return Routing(chosen, weights.view(n, k), ends, rows, pos)


def combine(y, weights, pos):
    """y [N * k, D] the experts' outputs in sorted order, weights [N, k]
    f32, pos [N, k] int32 -> out [N, D] in y's dtype: out[n] = sum_j
    w[n, j] * y[pos[n, j]], the weights rounded to y's dtype, summed in
    f32, rounded once. The kernel on CUDA tensors (y bf16), the twin on
    CPU tensors."""
    global combine_launches
    if not y.is_cuda:
        return combine_ref(y, weights, pos)
    n, k = pos.shape
    d = y.shape[-1]
    if (y.dtype != torch.bfloat16 or y.dim() != 2 or y.shape[0] != n * k
            or d % 8 or not y.is_contiguous() or y.data_ptr() % 16):
        raise ValueError(f"y: need a contiguous 16-byte-aligned bf16 "
                         f"[{n * k}, D] with D % 8 == 0, got {y.dtype} "
                         f"{tuple(y.shape)}")
    for name, a, dtype in (("weights", weights, torch.float32),
                           ("pos", pos, torch.int32)):
        if (a.dtype != dtype or tuple(a.shape) != (n, k)
                or not a.is_contiguous() or a.device != y.device):
            raise ValueError(f"{name}: need a contiguous {dtype} {(n, k)} on "
                             f"{y.device}, got {a.dtype} {tuple(a.shape)}")
    out = torch.empty(n, d, dtype=y.dtype, device=y.device)
    rc = build.library().fk_moe_combine(
        y.data_ptr(), weights.data_ptr(), pos.data_ptr(), out.data_ptr(),
        n, d, k,
        torch.cuda.current_stream(y.device).cuda_stream)
    build.check(rc, "moe_combine")
    combine_launches += 1
    return out
