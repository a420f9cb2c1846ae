"""GPT-2 decoder LM with brain-prefix conditioning
(``frankenstein_tpu/models/gpt2.py``).

- ``forward(idx, prefix, targets, train, generator)``: soft-prompt ``prefix``
  vectors before the token embeddings, learned positions over the full
  length, shifted CE over text positions ignoring -100. With ``train`` and
  ``cfg.dropout > 0``, dropout on the embedding, the attention
  probabilities, after ``c_proj`` and after the MLP, drawn from
  ``generator``. The head is the live tied ``wte``, so it gets its share of
  the gradient.
- Decode uses a fixed-shape KV cache with heads folded, ``[L, B, S, E]``
  (``init_cache`` / ``prefill`` / ``decode_step``), or its int8 form
  ``QuantCache`` (``quantize_cache`` after prefill). ``decode_step`` runs
  all blocks through kernel K2 (``ops/cuda/fused_decode.py``) where
  ``fused_decode.supported`` holds, else the module blocks;
  ``decode_step_topk`` returns the step's exact top-k and logsumexp instead
  of its logits, the head in kernel K8 (``ops/cuda/lm_head_topk.py``);
  ``reorder_cache`` gathers beams, through kernel K3
  (``ops/cuda/beam_reorder.py``) when the beams are grouped.
- ``lm_head`` is tied to ``transformer.wte``.
- ``dtype`` is the compute dtype (``models/layers.py``).
- ``cfg.moe_experts`` > 0 swaps every block's MLP for a ``MoESwiGLU``
  (``models/moe.py``, hidden 4E) as ``moe``; the training loss adds
  ``moe_aux_weight`` x the blocks' summed balancing losses, and decode runs
  the module blocks (K2 takes the dense MLP only, as the JAX package's
  fused path does).
- Tensor parallelism (``parallel/sharding.py:shard_params`` with
  ``GPT2_TP_RULES``): each block computes its heads' share (c_attn's q, k
  and v blocks, the local width, the attention-probability dropout masks
  its heads' slice of the masks one device draws), ``wte`` is looked up
  and the tied head computed by vocab part (the logits gathered over the
  model group). Training only: prefill, the decode steps and the stacked
  decode weights refuse a split model (``layers.refuse_tp``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from frankenstein_tpu_torch.config import GPTConfig, IGNORE_INDEX
from frankenstein_tpu_torch.models.layers import (LayerNorm, embedding,
                                                  linear, refuse_tp,
                                                  run_block)
from frankenstein_tpu_torch.models.moe import MoESwiGLU
from frankenstein_tpu_torch.ops import attention as attn_ops
from frankenstein_tpu_torch.ops.cuda import (beam_reorder, fused_decode,
                                             lm_head_topk)
from frankenstein_tpu_torch.parallel import mesh as mesh_lib


class QuantCache(NamedTuple):
    """int8 KV cache: codes plus fixed per-(layer, lane) dequant scales.
    Indexing [0]/[1] gives the sides, as for the float (k, v) tuple."""

    k: torch.Tensor        # [L, B, S, E] int8
    v: torch.Tensor        # [L, B, S, E] int8
    k_scale: torch.Tensor  # [L, 1, E] f32
    v_scale: torch.Tensor  # [L, 1, E] f32


def quantize_cache(cache) -> QuantCache:
    """(k, v) float caches -> QuantCache (symmetric absmax int8). A cache
    with more parts (LFM2's short-conv state beside its KV rows) raises:
    the int8 cache carries KV rows alone."""
    if len(cache) != 2:
        raise NotImplementedError(
            f"int8_kv quantizes a (k, v) cache; this one has {len(cache)} "
            "parts (a hybrid cache: the short-conv state beside the KV "
            "rows), which QuantCache and the int8-KV kernels cannot carry; "
            "serve with int8_kv=False")
    k8, ks = fused_decode.quantize_cache_side(cache[0])
    v8, vs = fused_decode.quantize_cache_side(cache[1])
    return QuantCache(k8, v8, ks, vs)


def on_float_cache(cache, dtype, fn):
    """fn(kv) on the float form of ``cache``: a float cache as it is, a
    ``QuantCache`` dequantized to ``dtype`` around the call and its codes
    then requantized IN PLACE with its own fixed scales (rows fn did not
    write round-trip to their codes). Returns fn's result."""
    if not isinstance(cache, QuantCache):
        return fn(cache)
    sides = ((cache.k, cache.k_scale), (cache.v, cache.v_scale))
    kv = [fused_decode.dequantize_cache_side(codes, sc, dtype)
          for codes, sc in sides]
    out = fn(kv)
    for (codes, sc), full in zip(sides, kv):
        codes.copy_(fused_decode.quantize_with_scales(full, sc))
    return out


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        e = cfg.n_embd
        self.c_attn = nn.Linear(e, 3 * e, bias=cfg.bias, device=device)
        self.c_proj = nn.Linear(e, e, bias=cfg.bias, device=device)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        e = cfg.n_embd
        self.c_fc = nn.Linear(e, 4 * e, bias=cfg.bias, device=device)
        self.c_proj = nn.Linear(4 * e, e, bias=cfg.bias, device=device)


def _generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    return (None if seed is None
            else torch.Generator(device=device).manual_seed(seed))


class GPTBlock(nn.Module):
    """One pre-LN block, run against a KV cache segment (``forward``) or
    over a whole sequence (``forward_full``, the training forward)."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.ln_1 = LayerNorm(cfg.n_embd, bias=cfg.bias, device=device)
        self.attn = CausalSelfAttention(cfg, device)
        self.ln_2 = LayerNorm(cfg.n_embd, bias=cfg.bias, device=device)
        if cfg.moe_experts > 0:
            self.moe = MoESwiGLU(cfg.n_embd, 4 * cfg.n_embd, cfg.moe_experts,
                                 cfg.moe_k, cfg.moe_capacity, device, dtype)
        else:
            self.mlp = MLP(cfg, device)

    def _mlp(self, x):
        """(the MLP sublayer's output, its balancing loss or None)."""
        if self.cfg.moe_experts > 0:
            return self.moe(self.ln_2(x))
        cdt = self.compute_dtype
        h = F.gelu(linear(self.ln_2(x), self.mlp.c_fc, cdt),
                   approximate="none")
        return linear(h, self.mlp.c_proj, cdt), None

    def forward(self, x, k_cache, v_cache, length: int):
        """x: [B, t, E]; k_cache/v_cache: this layer's [B, S, E], updated in
        place at rows [length, length + t)."""
        c = self.cfg
        b, t, e = x.shape
        s = k_cache.shape[1]
        q, k, v = linear(self.ln_1(x), self.attn.c_attn,
                         self.compute_dtype).split(e, dim=-1)
        k_cache[:, length:length + t] = k.to(k_cache.dtype)
        v_cache[:, length:length + t] = v.to(v_cache.dtype)
        heads = (b, s, c.n_head, c.head_dim)
        y = attn_ops.cached_attention(q.reshape(b, t, c.n_head, c.head_dim),
                                      k_cache.reshape(heads),
                                      v_cache.reshape(heads), length + 1)
        x = x + linear(y.reshape(b, t, e), self.attn.c_proj,
                       self.compute_dtype)
        return x + self._mlp(x)[0]

    def forward_full(self, x, rate: float = 0.0, seed: Optional[int] = None):
        """Causal attention of x [B, T, E] over itself: the cache forward
        with S = T from row 0, without a cache. Dropout at ``rate`` draws
        from a generator made from ``seed`` here, so a recomputation
        (``remat``) draws the same masks. A tensor-parallel block
        (``attn.c_attn.tp``) computes its heads from its local width.
        Returns (x, the MoE balancing loss or None)."""
        c = self.cfg
        b, t, _ = x.shape
        gen = _generator(seed, x.device)
        heads = lambda y: y.reshape(b, t, -1, c.head_dim)
        q, k, v = linear(self.ln_1(x), self.attn.c_attn,
                         self.compute_dtype).chunk(3, dim=-1)
        tp = getattr(self.attn.c_attn, "tp", None)
        part = None if tp is None else (1, mesh_lib.group_rank(tp[1]),
                                        mesh_lib.group_size(tp[1]))
        y = attn_ops.cached_attention(heads(q), heads(k), heads(v), 1,
                                      probs_dropout_rate=rate,
                                      generator=gen, dropout_part=part)
        y = linear(y.reshape(b, t, -1), self.attn.c_proj, self.compute_dtype)
        x = x + attn_ops.dropout(y, rate, gen)
        h, aux = self._mlp(x)
        return x + attn_ops.dropout(h, rate, gen), aux


def init_cache(cfg: GPTConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None):
    """Fixed-shape stacked KV cache: ([L, B, S, E], [L, B, S, E]) zeros."""
    shape = (cfg.n_layer, batch, max_len, cfg.n_embd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def stack_decode_weights(gpt: "GPT", cdt=None) -> dict:
    """The stacked-[L] dict kernel K2 consumes (``_stack_decode_weights``):
    matmul weights in [in, out] layout in the compute dtype ``cdt`` (the
    model's dtype by default); LayerNorm params and biases in f32, which is
    lossless since the kernel lifts them to f32 anyway. Also ``lm_head_t``,
    the tied head [E, V] in the model's dtype widened to f32, so decode
    steps do not re-widen it. Build it once per predictor, not per step.
    An MoE model has none: its decode runs the module blocks."""
    gpt.refuse_tp("stack_decode_weights")
    if gpt.cfg.moe_experts > 0:
        raise NotImplementedError(
            "stacked decode weights (K2, w8a16) take the dense MLP; an MoE "
            "GPT decodes through its module blocks with qweights=None")
    blocks = list(gpt.transformer["h"])
    cdt = cdt or gpt.dtype
    e = gpt.cfg.n_embd

    def vec(get, width):
        return torch.stack([
            get(b).detach().float() if get(b) is not None
            else torch.zeros(width, device=gpt.device) for b in blocks
        ]).contiguous()

    def mat(get):
        return torch.stack([get(b).detach().t().to(cdt)
                            for b in blocks]).contiguous()

    return {
        "ln1_w": vec(lambda b: b.ln_1.weight, e),
        "ln1_b": vec(lambda b: b.ln_1.bias, e),
        "qkv_w": mat(lambda b: b.attn.c_attn.weight),
        "qkv_b": vec(lambda b: b.attn.c_attn.bias, 3 * e),
        "proj_w": mat(lambda b: b.attn.c_proj.weight),
        "proj_b": vec(lambda b: b.attn.c_proj.bias, e),
        "ln2_w": vec(lambda b: b.ln_2.weight, e),
        "ln2_b": vec(lambda b: b.ln_2.bias, e),
        "fc_w": mat(lambda b: b.mlp.c_fc.weight),
        "fc_b": vec(lambda b: b.mlp.c_fc.bias, 4 * e),
        "fc2_w": mat(lambda b: b.mlp.c_proj.weight),
        "fc2_b": vec(lambda b: b.mlp.c_proj.bias, e),
        "lm_head_t": gpt.lm_head_table(),
    }


def quantize_decode_weights(gpt: "GPT", cdt=torch.bfloat16) -> dict:
    """w8a16 serving mode: the stacked dict with int8 matmul weights and
    per-(layer, out-lane) scales (``fused_decode.quantize_weights``)."""
    return fused_decode.quantize_weights(stack_decode_weights(gpt, cdt))


def cross_entropy_ignore(logits, targets, ignore_index: int = IGNORE_INDEX):
    """Mean CE over non-ignored positions. Under ``mesh.batch_shard`` the
    mean is over the global batch's kept targets, times the group size
    (this rank's share of the global loss, scaled as the mesh module
    sets out)."""
    logits = logits.float()
    mask = targets != ignore_index
    safe = torch.where(mask, targets, torch.zeros_like(targets))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    shard = mesh_lib.current_batch_shard()
    count = torch.clamp(mesh_lib.global_sum(mask.sum()), min=1)
    return nll.sum() * (shard.size if shard else 1) / count


class GPT(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.transformer = nn.ModuleDict({
            "wte": nn.Embedding(cfg.vocab_size, cfg.n_embd, device=device),
            "wpe": nn.Embedding(cfg.block_size, cfg.n_embd, device=device),
            "h": nn.ModuleList(GPTBlock(cfg, device, dtype)
                               for _ in range(cfg.n_layer)),
            "ln_f": LayerNorm(cfg.n_embd, bias=cfg.bias, device=device),
        })
        self.lm_head = nn.Linear(cfg.n_embd, cfg.vocab_size, bias=False,
                                 device=device)
        self.lm_head.weight = self.transformer["wte"].weight   # tied

    @property
    def dtype(self) -> torch.dtype:
        return self.transformer["wte"].weight.dtype

    @property
    def device(self) -> torch.device:
        return self.transformer["wte"].weight.device

    def init_decode_cache(self, batch: int, max_len: int):
        return init_cache(self.cfg, batch, max_len, self.dtype, self.device)

    def lm_head_table(self) -> torch.Tensor:
        """The tied head as [E, V] f32 (exact widening of the weights),
        detached: a serving table, never used in training."""
        return self.transformer["wte"].weight.detach().float().t()

    def _lm_head(self, x, table=None):
        """Tied head: f32 logits, products of compute-dtype values summed in
        f32. ``table``: a precomputed ``lm_head_table()``."""
        if table is None:
            table = self.lm_head_table()
        return x.float() @ table

    def refuse_tp(self, what: str) -> None:
        """Raise for ``what`` (a serving path) when the model is split for
        tensor parallelism."""
        block = self.transformer["h"][0]
        refuse_tp(what, [self.transformer["wte"], block.attn.c_attn,
                         *([block.mlp.c_fc] if hasattr(block, "mlp")
                           else [])])

    def _lm_head_live(self, x):
        """The training head: x @ wte^T on the live tied weight (cast to x's
        dtype, as the JAX package does), f32 logits, so ``wte`` gets the
        head's share of the gradient. A vocab-split ``wte`` computes its
        rows' logits and gathers the vocabulary over the model group."""
        wte = self.transformer["wte"]
        tp = getattr(wte, "tp", None)
        if tp is not None:
            x = mesh_lib.copy_to_group(x, tp[1])
            part = (x @ wte.weight.to(x.dtype).t()).float()
            return mesh_lib.gather_from_group(part, tp[1], -1)
        return (x @ wte.weight.to(x.dtype).t()).float()

    def _embed(self, idx, prefix):
        cdt = self.compute_dtype or self.dtype
        tok = embedding(idx, self.transformer["wte"]).to(cdt)
        if prefix is not None:
            tok = torch.cat([prefix.to(cdt), tok], dim=1)
        pos = self.transformer["wpe"].weight[:tok.shape[1]]
        return tok + pos[None].to(cdt)

    def _dropout_seeds(self, rate: float, generator) -> list:
        """One seed per block and one for the embedding, drawn from
        ``generator`` (one device-to-host read per forward, only while
        dropout is on)."""
        n = self.cfg.n_layer + 1
        if rate <= 0.0:
            return [None] * n
        if generator is None:
            raise ValueError("dropout > 0 in training needs a generator")
        return torch.randint(0, 2 ** 62, (n,), generator=generator,
                             device=generator.device).tolist()

    def _run_blocks(self, x, cache, length: int):
        for l, block in enumerate(self.transformer["h"]):
            x = block(x, cache[0][l], cache[1][l], length)
        return x

    def forward(self, idx, prefix=None, targets=None, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                remat: bool = False):
        """idx: [B, Tw]; prefix: [B, Tc, E] or None. Returns (loss, logits):
        logits over text positions (last position only without targets).
        ``train`` turns dropout on (``cfg.dropout``, drawn from
        ``generator``); ``remat`` recomputes each block in the backward."""
        t_words = idx.shape[1]
        rate = self.cfg.dropout if train else 0.0
        seeds = self._dropout_seeds(rate, generator)
        x = attn_ops.dropout(self._embed(idx, prefix), rate,
                             _generator(seeds[0], idx.device))
        aux = None
        for block, seed in zip(self.transformer["h"], seeds[1:]):
            x, aux_l = run_block(block.forward_full, x, rate, seed,
                                 remat=remat)
            if aux_l is not None:
                aux = aux_l if aux is None else aux + aux_l
        x = self.transformer["ln_f"](x[:, -t_words:])
        if targets is not None:
            logits = self._lm_head_live(x)
            loss = cross_entropy_ignore(logits[:, :-1], targets[:, 1:])
            if aux is not None:
                loss = loss + self.cfg.moe_aux_weight * aux
            return loss, logits
        return None, self._lm_head_live(x[:, -1:])

    @torch.no_grad()
    def prefill(self, idx, prefix, cache):
        """Run the prefix + initial tokens once, filling rows [0, t) of
        ``cache`` IN PLACE (the rest stays as given, zeros from
        ``init_cache``). Returns (logits_last [B, vocab] f32, cache, t)."""
        self.refuse_tp("prefill")
        x = self._embed(idx, prefix)
        t = x.shape[1]
        x = self._run_blocks(x, cache, 0)
        x = self.transformer["ln_f"](x[:, -1:])
        return self._lm_head(x)[:, 0], cache, t

    @torch.no_grad()
    def decode_step(self, token, cache, length: int,
                    qweights: Optional[dict] = None):
        """One decode step. token: [B] ids at absolute position ``length``.

        All blocks run in kernel K2 (its plain twin on the CPU) where
        ``fused_decode.supported`` holds, else in ``_decode_blocks_plain``;
        the new K/V rows land in ``cache`` IN PLACE either way. ``cache``
        may be a ``QuantCache``: K2 then runs its int8-KV mode and the
        scales stay as they are. ``qweights``: the stacked decode weights
        (``stack_decode_weights`` or ``quantize_decode_weights``), built
        once by the caller; None stacks them for this call.
        Returns (logits [B, vocab] f32, cache, length + 1)."""
        self.refuse_tp("decode_step")
        x, cache, qweights = self._decode_blocks(token, cache, length,
                                                 qweights)
        table = None if qweights is None else qweights.get("lm_head_t")
        x = self.transformer["ln_f"](x)
        return self._lm_head(x, table), cache, length + 1

    @torch.no_grad()
    def decode_step_topk(self, token, cache, length: int,
                         qweights: Optional[dict] = None, *, k: int):
        """One decode step returning the exact top-k instead of the logits
        (the JAX ``GPT.decode_step_topk``): the blocks as in ``decode_step``,
        then ln_f + the tied head + top-k + the full-vocab logsumexp in
        kernel K8 (``ops/cuda/lm_head_topk.py``) where its gate holds, so the
        [B, vocab] logits never exist; else ln_f, ``_lm_head``,
        ``exact_topk`` and ``torch.logsumexp``. int8 ``qweights`` raise: the
        JAX contract has no w8a16 here.

        Returns (vals [B, k] f32 descending, idx [B, k] int64 with ties to
        the lowest index, logz [B] f32, cache, length + 1); ``vals - logz``
        are exact log-probabilities."""
        self.refuse_tp("decode_step_topk")
        if qweights is not None and qweights["qkv_w"].dtype == torch.int8:
            raise NotImplementedError(
                "decode_step_topk takes no int8 decode weights (the JAX "
                "contract has no w8a16 here); serve with int8_weights=False")
        x, cache, qweights = self._decode_blocks(token, cache, length,
                                                 qweights)
        ln = self.transformer["ln_f"]
        wte = self.transformer["wte"].weight
        (b, e), v = x.shape, wte.shape[0]
        if lm_head_topk.supported(x.device, x.dtype, wte.dtype, b, e, v, k):
            vals, idx, logz = lm_head_topk.lm_head_topk(
                x, ln.weight, ln.bias, wte, k=k, eps=ln.eps)
        else:
            table = None if qweights is None else qweights.get("lm_head_t")
            logits = self._lm_head(ln(x), table)
            vals, idx = lm_head_topk.exact_topk(logits, k)
            logz = torch.logsumexp(logits, dim=-1)
        return vals, idx, logz, cache, length + 1

    def _decode_blocks(self, token, cache, length: int, qweights):
        """Embed ``token`` at ``length`` and run all blocks: K2 where
        ``fused_decode.supported`` holds (stacking the weights when
        ``qweights`` is None), else ``_decode_blocks_plain``. Returns
        (x [B, E], cache, qweights)."""
        quant = isinstance(cache, QuantCache)
        x = (self.transformer["wte"](token)
             + self.transformer["wpe"].weight[length][None])
        w_dtype = self.dtype if qweights is None else qweights["qkv_w"].dtype
        if self.cfg.moe_experts > 0 or not fused_decode.supported(
                x.device, x.dtype, w_dtype, cache[0].dtype, self.cfg.n_embd,
                self.cfg.n_head):
            return (self._decode_blocks_plain(x, cache, length, qweights),
                    cache, qweights)
        if qweights is None:
            qweights = stack_decode_weights(self)
        x, k, v = fused_decode.fused_decode_blocks(
            x, qweights, cache[0], cache[1], length,
            cache.k_scale if quant else None,
            cache.v_scale if quant else None, n_head=self.cfg.n_head)
        cache = (QuantCache(k, v, cache.k_scale, cache.v_scale) if quant
                 else (k, v))
        return x, cache, qweights

    def _decode_blocks_plain(self, x, cache, length: int, qweights):
        """x [B, E] through the module blocks at row ``length`` (the JAX
        package's scanned path), writing the new K/V rows into ``cache`` IN
        PLACE (``on_float_cache``). int8 block weights need K2."""
        if qweights is not None and qweights["qkv_w"].dtype == torch.int8:
            raise NotImplementedError(
                "int8 decode weights need kernel K2 (ops/cuda/"
                "fused_decode.py), which does not take this step; serve "
                "with int8_weights=False")
        return on_float_cache(
            cache, self.compute_dtype or self.dtype,
            lambda kv: self._run_blocks(x[:, None], kv, length)[:, 0])

    @staticmethod
    def reorder_cache(cache, flat_idx, group: int = 0):
        """Gather cache rows to a new (beam) order; batch is axis 1.
        ``QuantCache`` scales have no batch axis and are never gathered.

        ``group > 0`` asserts the beam-search contract that row g*w + n
        takes row g*w + p with p < w (w = ``group``): then kernel K3
        permutes both sides IN PLACE (its twin on the CPU). Otherwise a
        plain ``index_select`` returns new tensors."""
        k, v = cache[0], cache[1]
        if group > 0:
            k, v = beam_reorder.beam_reorder(k, v, flat_idx % group, w=group)
        else:
            k, v = k.index_select(1, flat_idx), v.index_select(1, flat_idx)
        if isinstance(cache, QuantCache):
            return QuantCache(k, v, cache.k_scale, cache.v_scale)
        return k, v


def init_gpt_(gpt: GPT, generator: torch.Generator) -> None:
    """Random weights at the JAX initialisers' scales (normal(0.02), the
    residual projections at 0.02/sqrt(2L), zero biases, unit norms)."""
    std_proj = 0.02 / math.sqrt(2 * gpt.cfg.n_layer)
    for name, p in gpt.named_parameters():
        if name.endswith("bias"):
            nn.init.zeros_(p)
        elif ".ln_" in name or name.startswith("transformer.ln_f"):
            nn.init.ones_(p)
        else:
            std = std_proj if name.endswith("c_proj.weight") else 0.02
            with torch.no_grad():
                p.normal_(0.0, std, generator=generator)
