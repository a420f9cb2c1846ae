"""Tensor-, expert- and fully-sharded parameter layouts
(``frankenstein_tpu/parallel/sharding.py``).

The rule tables are the JAX package's, as regexes over the port's
state-dict names; ``spec_for`` gives a parameter's placement as a tuple
with "model" at its split dimension (``()`` replicates), as the JAX
``PartitionSpec`` does. The port's ``nn.Linear`` weight is [out, in], the
transpose of flax's kernel, so a column split (output features) is its
dimension 0 and a row split (input features) its dimension 1.

- ``LLAMA_TP_RULES`` / ``GPT2_TP_RULES``: Megatron column splits of the
  q/k/v (gate/up, c_attn, c_fc) projections, row splits of the output
  (o_proj, down_proj, c_proj) projections, a vocab split of the embedding
  and head tables.
- ``MOE_EP_RULES``: the experts' stacks [E, ...] split on E. The JAX
  package keeps two rules because its LMs scan their blocks, so an LM's
  stacks are [L, E, ...] (``EXPERT_SCAN``, dimension 1) while a lone
  layer's are [E, ...] (``EXPERT``, dimension 0). The port's blocks are a
  ``ModuleList``, so the expert axis is dimension 0 of each block's stack
  under both rules; both stay, so a name resolves to the same rule as in
  the JAX package.
- ``fsdp_spec``: ZeRO-3 placement, the largest dimension the data
  dimension divides for a parameter of ``min_size`` elements or more.

Execution is by hand, not by DTensor (the port's ``models/layers.py:
linear`` reads ``layer.weight`` itself, which DTensor's module hooks would
not see): ``shard_params`` slices each matched weight to this rank's part
in place and tags its module with ``tp = (kind, group)``; ``linear``,
``embedding`` and the LMs' heads read the tag and add Megatron's
collectives (``parallel/mesh.py``), and the blocks reshape heads from the
local width. The GPT's fused c_attn [3E, E] is split as three column
blocks: rank r keeps rows [r E/m, (r+1) E/m) of each of q, k and v (its
bias likewise), so its output is [q_r | k_r | v_r]; JAX shards the fused
kernel's columns contiguously, which computes the same math.

The split goes by pairs, a column split feeding the row split after it
(c_attn / attn c_proj, c_fc / mlp c_proj, q/k/v / o_proj, gate/up /
down_proj): where the model group does not divide a member's dimension,
or an attention's heads, the whole pair stays on every rank, as does an
embedding or head table whose vocabulary does not divide. JAX's
``shard_params`` replicates a parameter whose split dimension the model
axis does not divide; a replicated pair computes the one-rank result,
which is what JAX's placement computes.
``shard_params_fsdp`` is FSDP2's ``fully_shard`` over the data dimension,
each parameter on ``fsdp_spec``'s dimension (``Shard(0)`` where the spec
replicates: FSDP2 shards every parameter).

Every sliced parameter carries ``shard_spec = (dim, group)``, or ``(dim,
group, blocks)`` for c_attn's three blocks, read by ``grad_norm``,
``full_state`` (full state dicts for checkpoints) and
``local_optimizer_state`` (a full optimizer state back to this rank's).
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from frankenstein_tpu_torch.parallel import mesh as mesh_lib

COL = "col"          # split output features
ROW = "row"          # split input features
VOCAB = "vocab"      # split the rows of an embedding table
EXPERT = "expert"    # split E of a stacked [E, ...] expert weight
EXPERT_SCAN = "expert_scan"   # the same inside an LM's block stack

LLAMA_TP_RULES: Sequence[Tuple[str, str]] = (
    (r".*(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$", COL),
    (r".*(o_proj|down_proj)\.weight$", ROW),
    (r".*(embed_tokens|lm_head)\.weight$", VOCAB),
)

MOE_EP_RULES: Sequence[Tuple[str, str]] = (
    (r".*\.moe\.(w1|w2|w3)$", EXPERT_SCAN),
    (r"(.*\.)?(w1|w2|w3)$", EXPERT),
)

GPT2_TP_RULES: Sequence[Tuple[str, str]] = (
    (r".*(c_attn|c_fc)\.weight$", COL),
    (r".*c_proj\.weight$", ROW),
    (r".*wte\.weight$", VOCAB),
)

_SPLIT_DIM = {COL: 0, ROW: 1, VOCAB: 0, EXPERT: 0, EXPERT_SCAN: 0}


def rule_for(name: str, rules):
    """The kind of the first rule whose pattern matches ``name``, or None."""
    for pattern, kind in rules:
        if re.match(pattern, name):
            return kind
    return None


def spec_for(name: str, shape, rules) -> tuple:
    """``name``'s placement: a tuple with "model" at the split dimension,
    or ``()`` (replicated) when no rule matches."""
    kind = rule_for(name, rules)
    if kind is None:
        return ()
    spec = [None] * len(shape)
    spec[_SPLIT_DIM[kind]] = mesh_lib.MODEL_AXIS
    return tuple(spec)


def fsdp_spec(shape, data_size: int, min_size: int = 2 ** 16) -> tuple:
    """ZeRO-3 placement over ``data_size`` ranks of the data dimension: the
    largest dimension it divides, ``()`` for a parameter under
    ``min_size`` elements or with no such dimension."""
    if data_size <= 1 or np.prod(shape) < min_size:
        return ()
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % data_size == 0:
            spec = [None] * len(shape)
            spec[d] = mesh_lib.DATA_AXIS
            return tuple(spec)
    return ()


def shard_params_fsdp(model: nn.Module, mesh, min_size: int = 2 ** 16):
    """FSDP2 over ``mesh``'s data dimension, the whole model one unit (its
    blocks run through methods such as ``forward_full`` that the unit
    hooks of a block would not see), each parameter sharded on
    ``fsdp_spec``'s dimension or dimension 0. Keeps ``shard_spec`` tags.
    Returns ``model``."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    data_mesh = mesh[mesh_lib.DATA_AXIS]
    size = data_mesh.size()

    def place(p):
        spec = fsdp_spec(tuple(p.shape), size, min_size)
        return Shard(spec.index(mesh_lib.DATA_AXIS)) if spec else None

    tags = {n: p.shard_spec for n, p in model.named_parameters()
            if hasattr(p, "shard_spec")}
    fully_shard(model, mesh=data_mesh, shard_placement_fn=place)
    for n, p in model.named_parameters():
        if n in tags:
            p.shard_spec = tags[n]
    return model


def _head_dim(model: nn.Module, unit: str):
    """The head width of an attention unit (a block's ``attn`` or
    ``self_attn``, read from the block's config), or None for any other
    unit."""
    if not unit.endswith("attn") or "." not in unit:
        return None
    cfg = getattr(model.get_submodule(unit.rsplit(".", 1)[0]), "cfg", None)
    return getattr(cfg, "head_dim", None)


def split_plan(model: nn.Module, size: int, rules=LLAMA_TP_RULES) -> dict:
    """{parameter name: (kind, dim, blocks)} of the parameters
    ``shard_params`` splits over a model group of ``size`` ranks. A layer
    matched by a column or row rule splits with the other matched layers
    of its parent (a block's attention or MLP) or not at all: all of them
    must divide by ``size`` on their split dimension, a fused c_attn in
    each of its three blocks, an attention projection in whole heads. A
    vocab-split table stands alone."""
    matched = {}
    for mod_name, mod in model.named_modules():
        for pname, p in mod._parameters.items():
            name = f"{mod_name}.{pname}" if mod_name else pname
            kind = rule_for(name, rules)
            if p is not None and kind is not None:
                matched[name] = (mod_name, kind, p)
    units = {}
    for name, (mod_name, kind, _) in matched.items():
        unit = (mod_name.rsplit(".", 1)[0] if kind in (COL, ROW)
                and "." in mod_name else name)
        units.setdefault(unit, []).append(name)
    plan = {}
    for unit, names in units.items():
        head = _head_dim(model, unit) or 1
        parts = {}
        for name in names:
            mod_name, kind, p = matched[name]
            blocks = 3 if mod_name.endswith("c_attn") else 1
            parts[name] = (kind, _SPLIT_DIM[kind], blocks)
            if p.shape[_SPLIT_DIM[kind]] % (size * blocks * head):
                break
        else:
            plan.update(parts)
    return plan


def shard_params(model: nn.Module, group, rules=LLAMA_TP_RULES) -> int:
    """Tensor (or expert) parallelism over ``group``: every parameter of
    ``split_plan`` keeps this rank's part in place (a column split's bias
    likewise), and its module is tagged ``tp = (kind, group)``; the rest,
    an indivisible pair included, stay whole on every rank. A tied weight
    stays tied. ``MOE_EP_RULES`` shard the experts
    (``models/moe.py:shard_experts``). Returns the number of parameters
    split."""
    from frankenstein_tpu_torch.models.moe import shard_experts
    m, r = mesh_lib.group_size(group), mesh_lib.group_rank(group)
    if rules is MOE_EP_RULES:
        return shard_experts(model, group)
    if m == 1:
        return 0
    done, weights = {}, set()
    for name, (kind, dim, blocks) in split_plan(model, m, rules).items():
        mod_name, pname = name.rsplit(".", 1) if "." in name else ("", name)
        mod = model.get_submodule(mod_name)
        p = mod._parameters[pname]
        weights.add(id(p))
        if id(p) not in done:
            done[id(p)] = _part(p, dim, m, r, group, blocks)
        if kind == COL and getattr(mod, "bias", None) is not None:
            done[id(mod.bias)] = _part(mod.bias, 0, m, r, group, blocks)
        mod.tp = (kind, group)
    for mod in model.modules():       # every holder of a split tensor
        for pname, p in list(mod._parameters.items()):
            if p is not None and id(p) in done:
                mod._parameters[pname] = done[id(p)]
    return len(weights)


def _cut(t: torch.Tensor, dim: int, m: int, r: int,
         blocks: int = 1) -> torch.Tensor:
    """Rank r's part of ``t``: its m-th of each of ``blocks`` equal blocks
    along ``dim``."""
    return torch.cat([b.chunk(m, dim=dim)[r]
                      for b in t.chunk(blocks, dim=dim)], dim=dim)


def _join(parts: list, dim: int, blocks: int = 1) -> torch.Tensor:
    """The whole tensor from every rank's ``_cut`` part, in rank order."""
    return torch.cat([torch.cat([p.chunk(blocks, dim=dim)[b] for p in parts],
                                dim=dim) for b in range(blocks)], dim=dim)


def _part(p: torch.Tensor, dim: int, m: int, r: int, group,
          blocks: int = 1) -> nn.Parameter:
    part = nn.Parameter(_cut(p.detach(), dim, m, r, blocks).clone())
    part.shard_spec = (dim, group) if blocks == 1 else (dim, group, blocks)
    return part


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def grad_norm(model: nn.Module, mesh=None) -> torch.Tensor:
    """The global L2 norm of the gradients in ``.grad``: squares of FSDP
    shards summed over the data dimension, of ``shard_spec`` parts over
    their group, replicated ones counted once."""
    sums = {}
    for p in model.parameters():
        if p.grad is None:
            continue
        fsdp = hasattr(p.grad, "to_local")
        spec = getattr(p, "shard_spec", None)
        key = (fsdp, None if spec is None else id(spec[1]))
        sq = torch.sum(torch.square(_local(p.grad).float()))
        if key in sums:
            sums[key] = (sums[key][0] + sq, spec)
        else:
            sums[key] = (sq, spec)
    if not sums:
        return torch.zeros(())
    total = None
    for (fsdp, _), (sq, spec) in sums.items():
        if fsdp:
            dist.all_reduce(sq, group=mesh_lib.group_of(mesh,
                                                        mesh_lib.DATA_AXIS))
        if spec is not None and mesh_lib.group_size(spec[1]) > 1:
            dist.all_reduce(sq, group=spec[1])
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _full(t: torch.Tensor, spec) -> torch.Tensor:
    """The whole tensor of a parameter's (or its optimizer state's) local
    value: an FSDP DTensor gathered, a ``shard_spec`` part gathered along
    its dimension."""
    t = t.detach()
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    if spec is not None and mesh_lib.group_size(spec[1]) > 1:
        dim, group = spec[:2]
        parts = [torch.empty_like(t) for _ in range(
            mesh_lib.group_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        t = _join(parts, dim, *spec[2:])
    return t


def _opt_params(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def full_state(model: nn.Module, optimizer) -> dict:
    """{"model", "optimizer"}: the full state dicts (CPU tensors) of a
    sharded model and its optimizer, as a one-device run's checkpoint holds
    them. Every rank must call it (the gathers are collectives)."""
    specs = {n: getattr(p, "shard_spec", None) for n, p in
             model.named_parameters(remove_duplicate=False)}
    sd = {n: _full(t, specs.get(n)).cpu()
          for n, t in model.state_dict().items()}
    osd = optimizer.state_dict()
    params = _opt_params(optimizer)
    state = {}
    for i, entry in osd["state"].items():
        spec = getattr(params[i], "shard_spec", None)
        state[i] = {k: (_full(v, spec).cpu()
                        if torch.is_tensor(v) and v.ndim > 0 else v)
                    for k, v in entry.items()}
    return {"model": sd, "optimizer": {"state": state,
                                       "param_groups": osd["param_groups"]}}


def local_optimizer_state(full: dict, optimizer) -> dict:
    """A full optimizer state dict (``full_state``'s, or a one-device
    run's) as this rank's: each tensor of a sharded parameter cut to the
    parameter's part, as a DTensor on the parameter's placements under
    FSDP2."""
    params = _opt_params(optimizer)
    state = {}
    for i, entry in full["state"].items():
        p = params[int(i)]
        spec = getattr(p, "shard_spec", None)
        out = {}
        for k, v in entry.items():
            if torch.is_tensor(v) and v.ndim > 0:
                if spec is not None:
                    v = _cut(v, spec[0], mesh_lib.group_size(spec[1]),
                             mesh_lib.group_rank(spec[1]), *spec[2:])
                if hasattr(p, "device_mesh"):
                    from torch.distributed.tensor import distribute_tensor
                    v = distribute_tensor(v.to(_local(p).device),
                                          p.device_mesh, p.placements)
            out[k] = v
        state[i] = out
    return {"state": state, "param_groups": full["param_groups"]}
