"""LLaMA-family decoder LM with brain-prefix conditioning and n-best
rescoring (``frankenstein_tpu/models/llama.py``).

- RMSNorm pre-norm, rotary GQA attention (adjacent-pair RoPE, as the JAX
  package computes it), SwiGLU, a tied or untied head. Module names are
  HF's (``model.embed_tokens``, ``model.layers[i].self_attn.{q,k,v,o}_proj``,
  ``mlp.{gate,up,down}_proj``, ``input_layernorm``,
  ``post_attention_layernorm``, ``model.norm``, ``lm_head``), so
  ``params_from_hf_llama`` maps an HF state dict by name.
- ``forward`` / ``sequence_logprob``: soft-prompt ``prefix`` vectors before
  the token embeddings, logits and loss over the text positions.
- Decode: a fixed-shape cache ``[L, B, S, E_kv]`` with the KV heads
  UNEXPANDED (``init_llama_cache``), or its int8 form
  (``gpt2.QuantCache``). ``prefill`` runs the module blocks;
  ``decode_step`` runs all blocks through kernel K5
  (``ops/cuda/fused_llama_decode.py``) on the card, its plain twin on the
  CPU, where ``fused_llama_decode.supported`` holds, else the module
  blocks. ``reorder_cache`` gathers beams through kernel K3.
- ``dtype`` is the compute dtype (``models/layers.py``).
- ``cfg.moe_experts`` > 0 swaps every block's SwiGLU for a ``MoESwiGLU``
  (``models/moe.py``, hidden ``cfg.hidden_dim``) as ``mlp``'s sibling
  ``moe``; the training loss adds ``moe_aux_weight`` x the blocks' summed
  balancing losses, and decode runs the module blocks (K5 takes the dense
  MLP only, as the JAX package's fused path does).
- Tensor parallelism (``parallel/sharding.py:shard_params``) splits the
  training forward; prefill, ``decode_step`` and the stacked decode
  weights refuse a split model (``layers.refuse_tp``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from frankenstein_tpu_torch.config import IGNORE_INDEX, LlamaConfig
from frankenstein_tpu_torch.models.gpt2 import (GPT, QuantCache,
                                                cross_entropy_ignore,
                                                on_float_cache)
from frankenstein_tpu_torch.models.layers import (RMSNorm, embedding,
                                                  linear, refuse_tp,
                                                  run_block)
from frankenstein_tpu_torch.models.moe import MoESwiGLU
from frankenstein_tpu_torch.ops import attention as attn_ops
from frankenstein_tpu_torch.ops import rope as rope_ops
from frankenstein_tpu_torch.ops.cuda import fused_llama_decode
from frankenstein_tpu_torch.parallel import mesh as mesh_lib


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        e, e_kv = cfg.dim, cfg.n_kv_heads * cfg.head_dim
        self.q_proj = nn.Linear(e, e, bias=False, device=device)
        self.k_proj = nn.Linear(e, e_kv, bias=False, device=device)
        self.v_proj = nn.Linear(e, e_kv, bias=False, device=device)
        self.o_proj = nn.Linear(e, e, bias=False, device=device)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        e, f = cfg.dim, cfg.hidden_dim
        self.gate_proj = nn.Linear(e, f, bias=False, device=device)
        self.up_proj = nn.Linear(e, f, bias=False, device=device)
        self.down_proj = nn.Linear(f, e, bias=False, device=device)


class LlamaBlock(nn.Module):
    """One pre-norm block, run against a KV cache segment (``forward``) or
    over a whole sequence (``forward_full``)."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.input_layernorm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.self_attn = LlamaAttention(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        if cfg.moe_experts > 0:
            self.moe = MoESwiGLU(cfg.dim, cfg.hidden_dim, cfg.moe_experts,
                                 cfg.moe_k, cfg.moe_capacity, device, dtype)
        else:
            self.mlp = LlamaMLP(cfg, device)

    def _qkv(self, x, rope):
        """q [B, t, H, D] and k, v [B, t, KV, D]; q and k rotated with the
        [t, D/2, 2] table ``rope``."""
        c, cdt = self.cfg, self.compute_dtype
        b, t, _ = x.shape
        h = self.input_layernorm(x)
        # heads from the width: a tensor-parallel rank holds its part
        q = linear(h, self.self_attn.q_proj, cdt).reshape(b, t, -1,
                                                          c.head_dim)
        k = linear(h, self.self_attn.k_proj, cdt).reshape(b, t, -1,
                                                          c.head_dim)
        v = linear(h, self.self_attn.v_proj, cdt).reshape(b, t, -1,
                                                          c.head_dim)
        return rope_ops.apply_rope(q, rope), rope_ops.apply_rope(k, rope), v

    def _expand(self, kv):
        """[B, S, KV, D] -> [B, S, H, D]: q head h reads KV head
        h // (H / KV) (HF's repeat-interleave)."""
        rep = self.cfg.n_heads // self.cfg.n_kv_heads
        return kv if rep == 1 else kv.repeat_interleave(rep, dim=2)

    def _rest(self, x, y):
        """x + o_proj(y), then the SwiGLU (or MoE) sublayer. Returns (x, the
        MoE balancing loss or None)."""
        b, t, _ = x.shape
        cdt = self.compute_dtype
        x = x + linear(y.reshape(b, t, -1), self.self_attn.o_proj, cdt)
        h = self.post_attention_layernorm(x)
        if self.cfg.moe_experts > 0:
            out, aux = self.moe(h)
            return x + out, aux
        gate = F.silu(linear(h, self.mlp.gate_proj, cdt))
        up = linear(h, self.mlp.up_proj, cdt)
        return x + linear(gate * up, self.mlp.down_proj, cdt), None

    def forward(self, x, k_cache, v_cache, length: int):
        """x: [B, t, E] at absolute positions [length, length + t);
        k_cache/v_cache: this layer's [B, S, E_kv], updated IN PLACE at
        rows [length, length + t)."""
        c = self.cfg
        b, t, _ = x.shape
        s = k_cache.shape[1]
        table = rope_ops.build_rope_cache(c.head_dim, s, c.rope_theta,
                                          device=x.device)
        q, k, v = self._qkv(x, table[length:length + t])
        k_cache[:, length:length + t] = k.reshape(b, t, -1).to(k_cache.dtype)
        v_cache[:, length:length + t] = v.reshape(b, t, -1).to(v_cache.dtype)
        heads = (b, s, -1, c.head_dim)
        y = attn_ops.cached_attention(q, self._expand(k_cache.reshape(heads)),
                                      self._expand(v_cache.reshape(heads)),
                                      length + 1)
        return self._rest(x, y)[0]

    def forward_full(self, x):
        """Causal attention of x [B, T, E] over itself: the cache forward
        with S = T from row 0, without a cache (differentiable). Returns
        (x, the MoE balancing loss or None)."""
        c = self.cfg
        table = rope_ops.build_rope_cache(c.head_dim, x.shape[1],
                                          c.rope_theta, device=x.device)
        q, k, v = self._qkv(x, table)
        y = attn_ops.cached_attention(q, self._expand(k), self._expand(v), 1)
        return self._rest(x, y)


def init_llama_cache(cfg: LlamaConfig, batch: int, max_len: int,
                     dtype=torch.float32, device=None):
    """Fixed-shape stacked KV cache ([L, B, S, E_kv], [L, B, S, E_kv])
    zeros, the KV heads unexpanded and folded into the lane axis."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads * cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.model = nn.Module()
        self.model.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim,
                                               device=device)
        self.model.layers = nn.ModuleList(LlamaBlock(cfg, device, dtype)
                                          for _ in range(cfg.n_layers))
        self.model.norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False,
                                 device=device)
        if cfg.tie_embeddings:
            self.lm_head.weight = self.model.embed_tokens.weight
        self._rope_rows = {}

    @property
    def dtype(self) -> torch.dtype:
        return self.model.embed_tokens.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def refuse_tp(self, what: str) -> None:
        """Raise for ``what`` (a serving path) when the model is split for
        tensor parallelism."""
        block = self.model.layers[0]
        refuse_tp(what, [self.model.embed_tokens, self.lm_head,
                         block.self_attn.q_proj,
                         *([block.mlp.gate_proj] if hasattr(block, "mlp")
                           else [])])

    def _cdt(self) -> torch.dtype:
        return self.compute_dtype or self.dtype

    def init_decode_cache(self, batch: int, max_len: int):
        return init_llama_cache(self.cfg, batch, max_len, self._cdt(),
                                self.device)

    def _head_dtype(self) -> torch.dtype:
        """The dtype of ``model.norm``'s output, which the head's weight is
        cast to."""
        return torch.promote_types(self._cdt(), self.model.norm.weight.dtype)

    def lm_head_table(self) -> torch.Tensor:
        """The head as [E, V] f32: the weight in the head's dtype, widened
        exactly, detached; a serving table, never used in training."""
        w = self.lm_head.weight.detach()
        return w.to(self._head_dtype()).float().t()

    def _head(self, x, table=None):
        """x @ w^T with w cast to x's dtype, products summed in f32 and f32
        logits (the JAX ``_head``). ``table``: a precomputed
        ``lm_head_table()``. A vocab-split head (``lm_head.tp``) computes
        its rows' logits and gathers the vocabulary over the group."""
        tp = getattr(self.lm_head, "tp", None)
        if tp is not None:
            x = mesh_lib.copy_to_group(x, tp[1])
            part = x.float() @ self.lm_head.weight.to(x.dtype).float().t()
            return mesh_lib.gather_from_group(part, tp[1], -1)
        if table is None:
            table = self.lm_head.weight.to(x.dtype).float().t()
        return x.float() @ table

    def _embed_in(self, idx, prefix):
        x = embedding(idx, self.model.embed_tokens).to(self._cdt())
        if prefix is not None:
            x = torch.cat([prefix.to(self._cdt()), x], dim=1)
        return x

    def _text_logits(self, idx, prefix, remat: bool = False):
        """(f32 logits over the text positions of ``idx`` [B, Tw], the
        blocks' summed MoE balancing loss or None); ``remat`` recomputes
        each block in the backward."""
        x = self._embed_in(idx, prefix)
        aux = None
        for block in self.model.layers:
            x, aux_l = run_block(block.forward_full, x, remat=remat)
            if aux_l is not None:
                aux = aux_l if aux is None else aux + aux_l
        return self._head(self.model.norm(x[:, -idx.shape[1]:])), aux

    def forward(self, idx, prefix=None, targets=None, remat: bool = False):
        """idx: [B, Tw]; prefix: [B, P, E] or None. Returns (loss, logits):
        logits over the text positions with ``targets`` (loss ignores -100),
        else (None, the last position's logits). ``remat`` recomputes each
        block's activations in the backward."""
        logits, aux = self._text_logits(idx, prefix, remat)
        if targets is not None:
            loss = cross_entropy_ignore(logits[:, :-1], targets[:, 1:])
            if aux is not None:
                loss = loss + self.cfg.moe_aux_weight * aux
            return loss, logits
        return None, logits[:, -1:]

    def sequence_logprob(self, idx, prefix=None,
                         ignore_index: int = IGNORE_INDEX):
        """Total log P(idx | prefix) over the positions after the first,
        ignoring ``ignore_index`` padding: the rescoring primitive. idx:
        [B, T] with trailing pads. Returns [B] f32."""
        mask = idx != ignore_index
        ids = torch.where(mask, idx, torch.zeros_like(idx))
        logp = torch.log_softmax(self._text_logits(ids, prefix)[0][:, :-1],
                                 dim=-1)
        tok = torch.gather(logp, -1, ids[:, 1:, None])[..., 0]
        return (tok * mask[:, 1:]).sum(-1)

    @torch.no_grad()
    def prefill(self, idx, prefix, cache):
        """Run the prefix + initial tokens once, filling rows [0, t) of
        ``cache`` IN PLACE (the rest stays as given, zeros from
        ``init_llama_cache``). Returns (logits_last [B, vocab] f32, cache,
        t)."""
        self.refuse_tp("prefill")
        x = self._embed_in(idx, prefix)
        t = x.shape[1]
        x = self._run_blocks(x, cache, 0)
        return self._head(self.model.norm(x[:, -1:]))[:, 0], cache, t

    def _run_blocks(self, x, cache, length: int):
        for l, block in enumerate(self.model.layers):
            x = block(x, cache[0][l], cache[1][l], length)
        return x

    def _rope_row(self, s: int, length: int):
        """The folded [1, E] f32 cos/sin rows of position ``length`` from
        tables built once per cache length ``s``."""
        key = (s, self.device)
        if key not in self._rope_rows:
            c = self.cfg
            table = rope_ops.build_rope_cache(c.head_dim, s, c.rope_theta,
                                              device=self.device)
            self._rope_rows[key] = rope_ops.folded_tables(table, c.n_heads)
        cos, sin = self._rope_rows[key]
        return cos[length:length + 1], sin[length:length + 1]

    @torch.no_grad()
    def decode_step(self, token, cache, length: int,
                    qweights: Optional[dict] = None):
        """One decode step. token: [B] ids at absolute position ``length``.

        All blocks run in kernel K5 (its plain twin on the CPU) where
        ``fused_llama_decode.supported`` holds, else in
        ``_decode_blocks_plain``; the new K/V rows land in ``cache`` IN
        PLACE either way. ``cache`` may be a ``QuantCache``: K5 then runs
        its int8-KV mode and the scales stay as they are. ``qweights``: the
        stacked decode weights (``stack_decode_weights`` or
        ``quantize_decode_weights``), built once by the caller; None stacks
        them for this call.
        Returns (logits [B, vocab] f32, cache, length + 1)."""
        self.refuse_tp("decode_step")
        c = self.cfg
        quant = isinstance(cache, QuantCache)
        x = self.model.embed_tokens(token).to(self._cdt())
        w_dtype = self._cdt() if qweights is None else qweights["wq"].dtype
        if c.moe_experts > 0 or not fused_llama_decode.supported(
                x.device, x.dtype, w_dtype, cache[0].dtype, c.dim,
                c.n_heads, c.n_kv_heads, c.hidden_dim, cache[0].shape[2]):
            x = self.model.norm(self._decode_blocks_plain(x, cache, length,
                                                          qweights))
            table = None if qweights is None else qweights.get("lm_head_t")
            return self._head(x, table), cache, length + 1
        if qweights is None:
            qweights = stack_decode_weights(self)
        cos, sin = self._rope_row(cache[0].shape[2], length)
        x, k, v = fused_llama_decode.fused_llama_decode_blocks(
            x, qweights, cache[0], cache[1], length, cos, sin,
            cache.k_scale if quant else None,
            cache.v_scale if quant else None, n_heads=c.n_heads,
            n_kv_heads=c.n_kv_heads, eps=c.norm_eps)
        cache = (QuantCache(k, v, cache.k_scale, cache.v_scale) if quant
                 else (k, v))
        x = self.model.norm(x)
        return self._head(x, qweights.get("lm_head_t")), cache, length + 1

    def _decode_blocks_plain(self, x, cache, length: int, qweights):
        """x [B, E] through the module blocks at row ``length`` (the JAX
        package's scanned path), writing the new K/V rows into ``cache`` IN
        PLACE (``gpt2.on_float_cache``). int8 block weights need K5."""
        if qweights is not None and qweights["wq"].dtype == torch.int8:
            raise NotImplementedError(
                "int8 decode weights need kernel K5 (ops/cuda/"
                "fused_llama_decode.py), which does not take this step; "
                "serve with int8_weights=False")
        return on_float_cache(
            cache, self._cdt(),
            lambda kv: self._run_blocks(x[:, None], kv, length)[:, 0])

    # the [L, B, S, E_kv] cache has GPT's layout (batch at axis 1), so GPT's
    # beam-order gather (kernel K3 when group > 0) serves it as it is
    reorder_cache = staticmethod(GPT.reorder_cache)

    @staticmethod
    def expand_cache(cache, w: int):
        """Replicate a batch-B prefilled cache to B*W beam rows, each
        sentence's W beams adjacent (batch at axis 1; ``QuantCache`` scales
        have no batch axis)."""
        rep = lambda t: t.repeat_interleave(w, dim=1)
        if isinstance(cache, QuantCache):
            return QuantCache(rep(cache.k), rep(cache.v), cache.k_scale,
                              cache.v_scale)
        return tuple(rep(t) for t in cache)


def stack_decode_weights(llama: Llama, cdt=None) -> dict:
    """The stacked-[L] dict kernel K5 consumes: matmul weights [L, in, out]
    in the compute dtype ``cdt`` (the model's by default), RMSNorm weights
    [L, E] in f32 (exact: the kernel lifts them to f32 anyway), and
    ``lm_head_t``, the head table of ``Llama.lm_head_table``. Build it once
    per predictor, not per step. An MoE model has none: its decode runs
    the module blocks."""
    llama.refuse_tp("stack_decode_weights")
    if llama.cfg.moe_experts > 0:
        raise NotImplementedError(
            "stacked decode weights (K5, w8a16) take the dense MLP; an MoE "
            "LLaMA decodes through its module blocks with qweights=None")
    blocks = list(llama.model.layers)
    cdt = cdt or llama._cdt()

    def mat(get):
        return torch.stack([get(b).weight.detach().t().to(cdt)
                            for b in blocks]).contiguous()

    def vec(get):
        return torch.stack([get(b).weight.detach().float()
                            for b in blocks]).contiguous()

    return {
        "norm1_w": vec(lambda b: b.input_layernorm),
        "wq": mat(lambda b: b.self_attn.q_proj),
        "wk": mat(lambda b: b.self_attn.k_proj),
        "wv": mat(lambda b: b.self_attn.v_proj),
        "wo": mat(lambda b: b.self_attn.o_proj),
        "norm2_w": vec(lambda b: b.post_attention_layernorm),
        "wg": mat(lambda b: b.mlp.gate_proj),
        "wu": mat(lambda b: b.mlp.up_proj),
        "wd": mat(lambda b: b.mlp.down_proj),
        "lm_head_t": llama.lm_head_table(),
    }


def quantize_decode_weights(llama: Llama, cdt=torch.bfloat16) -> dict:
    """w8a16 serving mode: the stacked dict with int8 matmul weights and
    per-(layer, out-lane) scales (``fused_llama_decode.quantize_weights``)."""
    return fused_llama_decode.quantize_weights(stack_decode_weights(llama,
                                                                    cdt))


def candidates_from_beams(toks, eot_id: int, seed_id: Optional[int] = None):
    """[B, W, T] n-best beam tokens (``beam_search(n_best=True)``) -> the
    [B, W, T+1] ``rescore_candidates`` input: the seed token (default
    ``eot_id``, the decode prompt) is prepended and the first EOT is kept;
    only the frozen pad tail strictly after it becomes IGNORE_INDEX, so
    every hypothesis is priced as log P(tokens, EOT | seed). Host-side
    numpy; returns a tensor on ``toks``' device."""
    t_in = torch.as_tensor(toks)
    arr = t_in.cpu().numpy()
    b, w, t = arr.shape
    seed = eot_id if seed_id is None else seed_id
    out = np.full((b * w, t + 1), seed, arr.dtype)
    out[:, 1:] = arr.reshape(b * w, t)
    for row in out:
        hits = np.where(row[1:] == eot_id)[0]
        if len(hits):
            row[hits[0] + 2:] = IGNORE_INDEX
    return torch.from_numpy(out.reshape(b, w, t + 1)).to(t_in.device)


@torch.no_grad()
def rescore_candidates(model, candidates, decoder_scores=None, prefix=None,
                       alpha: float = 0.5, length_normalize: bool = True):
    """Rescore n-best beam outputs with the LM ``model`` (a ``Llama`` or a
    module with its ``sequence_logprob``).

    candidates: [B, N, T] ids (-100 pads); decoder_scores: [B, N] from the
    beam search; prefix: [B, P, E] brain vectors in the LM's embedding
    space, repeated over the candidates. Returns (best_idx [B], combined
    [B, N])."""
    b, n, t = candidates.shape
    flat = candidates.reshape(b * n, t)
    pfx = prefix.repeat_interleave(n, dim=0) if prefix is not None else None
    lm_scores = model.sequence_logprob(flat, pfx).reshape(b, n)
    if length_normalize:
        lengths = (candidates != IGNORE_INDEX).sum(-1)
        lm_scores = lm_scores / torch.clamp(lengths - 1, min=1)
    combined = lm_scores if decoder_scores is None else (
        alpha * lm_scores + (1 - alpha) * decoder_scores)
    return torch.argmax(combined, dim=-1), combined


def _half_split_to_adjacent(w, n_heads: int, head_dim: int):
    """Reorder the output rows of an HF q/k projection [H*D, in] within each
    head, from HF's half-split rotary pairs (i, i + D/2) to the adjacent
    pairs (2i, 2i+1) that the port rotates."""
    half = torch.arange(head_dim // 2)
    per_head = torch.stack([half, half + head_dim // 2], dim=1).reshape(-1)
    rows = (torch.arange(n_heads)[:, None] * head_dim + per_head).reshape(-1)
    return w[rows]


def params_from_hf_llama(state_dict: Mapping, config) -> tuple:
    """Map an HF ``LlamaForCausalLM`` state dict (tensors or arrays) and its
    config (a dict, or an object with HF's attribute names) to
    (LlamaConfig, the port's state dict). Imports no ``transformers``.

    The q/k projections' output rows are permuted within each head from
    HF's half-split rotary pairs to the port's adjacent pairs, so the port
    reproduces HF's logits."""
    get = (config.get if isinstance(config, Mapping)
           else lambda k, d=None: getattr(config, k, d))
    for key in ("rope_scaling", "attention_bias", "mlp_bias"):
        if get(key):
            raise NotImplementedError(f"HF config {key}={get(key)!r} is not "
                                      "supported")
    cfg = LlamaConfig(
        vocab_size=get("vocab_size"), dim=get("hidden_size"),
        n_layers=get("num_hidden_layers"),
        n_heads=get("num_attention_heads"),
        n_kv_heads=get("num_key_value_heads") or get("num_attention_heads"),
        hidden_dim=get("intermediate_size"),
        rope_theta=float(get("rope_theta", 10000.0)),
        norm_eps=get("rms_norm_eps"),
        max_seq_len=get("max_position_embeddings"),
        tie_embeddings=bool(get("tie_word_embeddings", False)))
    sd = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor)
          else v.detach() for k, v in state_dict.items()}
    out = {}
    for name, value in sd.items():
        if name.endswith("rotary_emb.inv_freq"):
            continue
        if name.endswith("self_attn.q_proj.weight"):
            value = _half_split_to_adjacent(value, cfg.n_heads, cfg.head_dim)
        elif name.endswith("self_attn.k_proj.weight"):
            value = _half_split_to_adjacent(value, cfg.n_kv_heads,
                                            cfg.head_dim)
        out[name] = value
    if cfg.tie_embeddings:
        out.setdefault("lm_head.weight", out["model.embed_tokens.weight"])
    return cfg, out
