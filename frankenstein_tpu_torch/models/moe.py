"""Mixture-of-Experts SwiGLU layers: the JAX package's capacity-bound
``MoESwiGLU`` with expert parallelism (``frankenstein_tpu/models/moe.py``),
and the port's dropless ``RoutedExperts`` (LFM2-MoE's router, sorted
rows and grouped products; on the card the routing is two hand-written
kernels, ``ops/cuda/moe_route.py``: one launch scores, picks, counting-
sorts and offsets the rows, one unsorts and sums each row's outputs).

The JAX package's GShard / Switch layer with static shapes:

- the router is f32: softmax(x @ wg), top-k with ties to the lower expert
  index (as ``jax.lax.top_k``; a stable sort, since ``torch.topk`` promises
  no order on ties), gates renormalised over the chosen experts;
- capacity ``cap = max(1, int(cf * N * k / E))`` slots an expert, and
  ``cap = N`` for a one-position call (cached decode), so serving drops
  nothing; priority is all first choices before any second choice, then
  token order; a choice past its expert's capacity is dropped (its gate is
  zero and the residual carries the token);
- dispatch and combine are dense one-hot [N, E, C] tensors and the experts'
  SwiGLU products batched einsums over the stacked ``w1``, ``w3`` [E, d, f]
  and ``w2`` [E, f, d], as the JAX package stores them;
- the Switch load-balancing loss E * sum_e(first-choice share_e x mean
  router prob_e), 1 at perfect balance.

The products stay plain ``einsum``: the JAX package computes them outside
any Pallas kernel, so there is no kernel to port here.

Parallel modes:

- data parallelism (``parallel.mesh.batch_shard``): N, the capacity and
  each slot come from the global batch. The per-rank [K, E] choice counts
  are gathered over the data group and a rank's slots start after every
  earlier choice rank and every earlier rank of its own choice rank. The
  aux loss takes the global first-choice share, so its mean over the data
  group is the global loss;
- expert parallelism (``shard_experts``): ``expert_group`` holds ranks with
  the same tokens; each keeps E / m experts, computes their share of every
  token's output and the shares are summed over the group (a sum forward,
  the identity backward), while the tokens and gates enter through
  ``copy_to_group`` so their gradients sum the experts of every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from frankenstein_tpu_torch.ops.cuda import moe_route
from frankenstein_tpu_torch.parallel import mesh as mesh_lib
from frankenstein_tpu_torch.utils.profiling import span

grouped_calls = 0   # grouped products launched (two a RoutedExperts call)
# RoutedExperts.layer -> [E] int64 on the layer's device: the running sum of
# each call's end offsets (rows routed to experts 0..e), accumulated on the
# device with no host sync; ``rows_per_expert`` turns it into counts
expert_ends: dict = {}


def stable_topk(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, in
    descending order, ties to the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _slot_positions(assign: torch.Tensor) -> torch.Tensor:
    """assign [N, K, E] one-hot choices -> pos [N, K]: each choice's slot in
    its expert's queue, first choices of every token before any second
    choice, then token order, over the global batch under
    ``mesh.batch_shard``."""
    n, k, e = assign.shape
    # exclusive prefix over the tokens within each choice rank
    within = torch.cumsum(assign, dim=0) - assign                 # [N, K, E]
    counts = assign.sum(0)                                         # [K, E]
    shard = mesh_lib.current_batch_shard()
    if shard is None:
        every = counts[None]                                       # [1, K, E]
        rank = 0
    else:
        parts = [torch.empty_like(counts) for _ in range(shard.size)]
        dist.all_gather(parts, counts.contiguous(), group=shard.group)
        every = torch.stack(parts)                                 # [W, K, E]
        rank = shard.rank
    total = every.sum(0)                                           # [K, E]
    base = (torch.cumsum(total, 0) - total) + every[:rank].sum(0)  # [K, E]
    return ((within + base[None]) * assign).sum(-1)                # [N, K]


class MoESwiGLU(nn.Module):
    """Sparse SwiGLU MLP over [B, T, dim]: returns (y [B, T, dim] in the
    compute dtype, aux f32 scalar). ``dtype`` is the compute dtype (None:
    the parameters')."""

    def __init__(self, dim: int, hidden_dim: int, n_experts: int, k: int = 2,
                 capacity_factor: float = 1.25, device=None, dtype=None):
        super().__init__()
        self.dim, self.hidden_dim = dim, hidden_dim
        self.n_experts, self.k = n_experts, k
        self.capacity_factor = capacity_factor
        self.compute_dtype = dtype
        self.wg = nn.Parameter(torch.zeros(dim, n_experts, device=device))
        self.w1 = nn.Parameter(torch.zeros(n_experts, dim, hidden_dim,
                                           device=device))
        self.w3 = nn.Parameter(torch.zeros(n_experts, dim, hidden_dim,
                                           device=device))
        self.w2 = nn.Parameter(torch.zeros(n_experts, hidden_dim, dim,
                                           device=device))
        self.expert_group = None     # set by shard_experts
        self.expert_offset = 0       # first expert this rank holds

    def capacity(self, n_tok: int, t: int) -> int:
        if t == 1:
            return n_tok
        return max(1, int(self.capacity_factor * n_tok * self.k
                          / self.n_experts))

    def forward(self, x: torch.Tensor):
        b, t, d = x.shape
        e, k = self.n_experts, self.k
        shard = mesh_lib.current_batch_shard()
        n_tok = b * t
        n_global = n_tok * (shard.size if shard else 1)
        cap = self.capacity(n_global, t)
        cdt = self.compute_dtype or self.w1.dtype
        xt = x.reshape(n_tok, d).to(cdt)

        # router, f32
        probs = torch.softmax(xt.float() @ self.wg.float(), dim=-1)   # [N, E]
        gate_vals, gate_idx = stable_topk(probs, k)                   # [N, K]
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)

        # capacity assignment
        assign = F.one_hot(gate_idx, e)                               # [N,K,E]
        pos = _slot_positions(assign)
        keep = pos < cap
        gate_vals = gate_vals * keep

        # experts: this rank's slice of the stack
        group = self.expert_group
        xt_in = mesh_lib.copy_to_group(xt, group)
        gates_in = mesh_lib.copy_to_group(gate_vals, group)
        lo, n_loc = self.expert_offset, self.w1.shape[0]
        slot = F.one_hot(torch.where(keep, pos, cap),
                         cap + 1)[..., :cap].to(cdt)                  # [N,K,C]
        disp_k = (assign[..., lo:lo + n_loc, None].to(cdt)
                  * slot[:, :, None, :])                              # [N,K,e,C]
        dispatch = disp_k.sum(1)                                      # [N,e,C]
        combine = (gates_in.to(cdt)[..., None, None] * disp_k).sum(1)
        xe = torch.einsum("nec,nd->ecd", dispatch, xt_in)             # [e,C,D]
        h = (F.silu(torch.einsum("ecd,edf->ecf", xe, self.w1.to(cdt)))
             * torch.einsum("ecd,edf->ecf", xe, self.w3.to(cdt)))
        ye = torch.einsum("ecf,efd->ecd", h, self.w2.to(cdt))
        y = torch.einsum("nec,ecd->nd", combine, ye.to(cdt))
        y = mesh_lib.reduce_from_group(y, group)

        # Switch load-balancing loss, the first-choice share global
        first = F.one_hot(gate_idx[:, 0], e).float().sum(0)
        share = mesh_lib.global_sum(first) / n_global
        aux = e * torch.sum(share * probs.mean(0))
        return y.reshape(b, t, d), aux


def shard_experts(model: nn.Module, group) -> int:
    """Expert parallelism: every ``MoESwiGLU`` in ``model`` keeps experts
    [r * E/m, (r+1) * E/m) of its stack (r, m: this rank's index and the
    size of ``group``) and sums its share of the output over ``group``.
    Returns the number of layers sharded. E must divide by m."""
    m, r = mesh_lib.group_size(group), mesh_lib.group_rank(group)
    count = 0
    for mod in model.modules():
        if not isinstance(mod, MoESwiGLU) or m == 1:
            continue
        if mod.n_experts % m:
            raise ValueError(f"{mod.n_experts} experts do not split over "
                             f"{m} ranks")
        n_loc = mod.n_experts // m
        for name in ("w1", "w2", "w3"):
            full = getattr(mod, name)
            part = full.detach()[r * n_loc:(r + 1) * n_loc].clone()
            setattr(mod, name, nn.Parameter(part))
            getattr(mod, name).shard_spec = (0, group)
        mod.expert_group, mod.expert_offset = group, r * n_loc
        count += 1
    return count


def _ends_sum(layer: int, n_experts: int, device) -> torch.Tensor:
    """``expert_ends[layer]``, the running sum the route adds each call's
    end offsets [E] to (zeros the first time on ``device``)."""
    have = expert_ends.get(layer)
    if (have is None or have.device != torch.device(device)
            or have.shape != (n_experts,)):
        have = expert_ends[layer] = torch.zeros(n_experts, dtype=torch.long,
                                                device=device)
    return have


def rows_per_expert() -> torch.Tensor:
    """[layers, E] int64 on the host: the rows routed to each expert of
    each ``RoutedExperts`` layer (sorted by ``layer``) since the process
    started, or an empty tensor."""
    if not expert_ends:
        return torch.zeros(0, 0, dtype=torch.long)
    ends = torch.stack([expert_ends[k].cpu() for k in sorted(expert_ends)])
    return torch.diff(ends, dim=1, prepend=torch.zeros_like(ends[:, :1]))


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """Rows [ends[e-1], ends[e]) of x [N, K] times w[e] [K, M], for every
    expert e of w [E, K, M] at once (``torch._grouped_mm``; ``ends`` int32
    [E], the rows sorted by expert). Returns [N, M] in x's dtype."""
    global grouped_calls
    grouped_calls += 1
    return torch._grouped_mm(x, w, offs=ends)


class RoutedExperts(nn.Module):
    """Dropless routed SwiGLU experts over [..., dim] with LFM2-MoE's router
    (HF ``lfm2_moe``'s sparse block); returns the same shape in the compute
    dtype ``dtype`` (None: the parameters'). The router reads x as given
    (an f32 x in f32), the products in the compute dtype.

    - the router runs in f32: ``s = sigmoid(h @ gate)``; the chosen experts
      are ``topk(s + expert_bias, k)`` (the bias picks experts and weighs
      nothing); their weights are ``s`` at the chosen, over their sum plus
      1e-6 (``norm_topk_prob``), times ``routed_scaling``;
    - no capacity: the (row, choice) pairs are counting-sorted by expert
      on the device (stable, so each expert's rows keep their order) and
      every pair goes through two grouped products over the sorted rows,
      gate | up stacked as ``gate_up_proj`` [E, dim, 2 hidden], then
      ``down_proj`` [E, hidden, dim]; nothing waits on the host;
    - each row sums its k outputs, gathered at their sorted positions and
      weighed by its weights in the compute dtype, in f32, rounded once.

    On the card the router, the top k, the sort and the offsets are ONE
    launch of ``ops/cuda/moe_route.py:route`` (``csrc/moe_route.cu``),
    which also adds the offsets to the running count, and the unsort and
    the weighted sum one of ``combine``; on the CPU their plain twins run.
    Top-k ties go to the lower expert index, NaN before any number. The
    layer owns the route kernel's arrival count (``moe_route.
    arrival_count``), made at its first call on a device (before any
    capture: the step graphs warm up eagerly first), so one layer's calls
    must not run at the same time on two streams, as its running count
    ``expert_ends[layer]`` forbids anyway. Under a profiler the three
    phases are the spans ``moe.route`` (the route kernel), ``moe.experts``
    (the rows' gather, both products and the SwiGLU between them) and
    ``moe.combine`` (the combine kernel). Each call adds its end offsets
    to ``expert_ends[layer]`` (``rows_per_expert``), its two products to
    ``grouped_calls`` and its launches to ``moe_route.launches`` and
    ``moe_route.combine_launches``."""

    def __init__(self, dim: int, hidden_dim: int, n_experts: int, k: int, *,
                 use_expert_bias: bool = True, norm_topk_prob: bool = True,
                 routed_scaling: float = 1.0, layer: int = 0, device=None,
                 dtype=None):
        super().__init__()
        self.hidden_dim, self.n_experts, self.k = hidden_dim, n_experts, k
        self.norm_topk_prob = norm_topk_prob
        self.routed_scaling = routed_scaling
        self.layer = layer
        self.compute_dtype = dtype
        self.gate = nn.Linear(dim, n_experts, bias=False, device=device)
        self.expert_bias = (nn.Parameter(torch.zeros(n_experts,
                                                     device=device))
                            if use_expert_bias else None)
        self.gate_up_proj = nn.Parameter(torch.zeros(
            n_experts, dim, 2 * hidden_dim, device=device))
        self.down_proj = nn.Parameter(torch.zeros(n_experts, hidden_dim, dim,
                                                  device=device))
        self.arrived = None   # the route kernel's arrival count

    def route(self, h: torch.Tensor):
        """h [N, dim] -> (chosen experts [N, k] int32, their weights [N, k]
        f32), by the plain twin."""
        return moe_route.select_ref(
            moe_route.scores_ref(h, self.gate.weight), self.expert_bias,
            self.k, self.norm_topk_prob, self.routed_scaling)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype or self.gate_up_proj.dtype
        h = x.reshape(-1, x.shape[-1])
        f = self.hidden_dim
        if h.is_cuda and (self.arrived is None
                          or self.arrived.device != h.device):
            self.arrived = moe_route.arrival_count(h.device)
        with span("moe.route"):
            r = moe_route.route(
                h, self.gate.weight, self.expert_bias, self.k,
                arrived=self.arrived, norm_topk_prob=self.norm_topk_prob,
                routed_scaling=self.routed_scaling,
                ends_sum=_ends_sum(self.layer, self.n_experts, h.device))
        with span("moe.experts"):
            gu = grouped_mm(h.index_select(0, r.rows).to(cdt),
                            self.gate_up_proj.to(cdt), r.ends)
            act = F.silu(gu[:, :f]) * gu[:, f:]
            y = grouped_mm(act, self.down_proj.to(cdt), r.ends)
        with span("moe.combine"):
            out = moe_route.combine(y, r.weights, r.pos)
        return out.reshape(x.shape)
