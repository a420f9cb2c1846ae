"""LFM2-MoE: LiquidAI's decoder of gated short convolutions and GQA
attention layers with dropless sigmoid-routed experts (HF ``lfm2_moe``,
LFM2-8B-A1B by default), the LM of ``models/franky.py:FrankyLfm2``.

- Module names are HF's: ``model.embed_tokens``, ``model.layers[i]``
  with ``operator_norm``, ``ffn_norm``, ``conv.{in_proj, conv, out_proj}``
  or ``self_attn.{q,k,v,out}_proj`` and ``self_attn.{q,k}_layernorm``, and
  ``feed_forward`` (``w1``, ``w2``, ``w3`` in the ``num_dense_layers``
  leading layers, ``models/moe.py:RoutedExperts`` after them),
  ``model.embedding_norm``.
- A layer is ``h = x + op(operator_norm(x))``, ``out = h +
  feed_forward(ffn_norm(h))``, RMSNorm at ``norm_eps``. The conv ``op``:
  ``[B, C, u] = split3(in_proj(h))``, ``v`` the depthwise causal
  convolution (kernel ``conv_L_cache``) of ``B * u``, ``out_proj(C * v)``.
  The attention ``op``: q and k RMS-normed per head, then rotated by
  HF's half-split RoPE at ``rope_theta``; causal GQA at 1/sqrt(head_dim).
- ``logits``: soft-prompt ``prefix`` vectors before the
  token embeddings (``Llama._embed_in``), logits over the text positions
  from the head tied to ``model.embed_tokens``.
- Decode keeps a ``HybridCache``: the attention layers' (k, v) [A, B, S,
  KV*D] with KV heads unexpanded (``Llama``'s layout, batch at axis 1) and
  the conv layers' state [C, B, L - 1, dim], the last ``conv_L_cache - 1``
  rows of ``B * u``. ``prefill`` fills both, ``decode_step`` runs the
  module layers at row ``length`` (on the card as a CUDA graph a position,
  ``StepGraphs``), ``reorder_cache`` permutes (k, v)
  through kernel K3 and gathers the conv state by the same parents,
  ``expand_cache`` repeats both. The int8 cache and w8a16 weights (the
  fused decode kernels' modes) have no LFM2 form and raise.
- ``dtype`` is the compute dtype (``models/layers.py``) of the products,
  the cache and the conv state. The residual stream, the norms, RoPE and
  the router are f32, the conv's taps and each row's sum over its experts
  accumulate in f32, and the head is a product in the compute dtype
  summed into f32 logits.

Under a profiler each conv operator is a ``lfm2.conv`` span and each
attention operator a ``lfm2.attn`` span (``utils/profiling.py:span``).

Departures from HF ``lfm2_moe``, none of which changes a published width:
the routed experts are stacked (``gate_up_proj`` [E, dim, 2F], gate then
up, and ``down_proj`` [E, F, dim]) for grouped products, and
``expert_bias`` is a parameter (HF: a float32 buffer), cast with the rest
for serving; the residual stream, the router and RoPE are f32 (HF: the
model's dtype), so RMSNorm multiplies by its weight before rounding (HF:
after); the head has no parameter of its own and its logits are f32 (HF:
the model's dtype); no padding mask (every row is full length).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch.autograd import _profiler_enabled

from frankenstein_tpu_torch.config import Lfm2MoeConfig
from frankenstein_tpu_torch.models import moe
from frankenstein_tpu_torch.models.gpt2 import GPT
from frankenstein_tpu_torch.models.layers import RMSNorm, SwiGLU, linear
from frankenstein_tpu_torch.models.moe import RoutedExperts
from frankenstein_tpu_torch.ops.cuda import moe_route
from frankenstein_tpu_torch.utils.profiling import span


class HybridCache(NamedTuple):
    """LFM2's decode state: [0] and [1] are the attention layers' sides, as
    for the (k, v) tuple of the other LMs."""

    k: torch.Tensor       # [A, B, S, KV*D]
    v: torch.Tensor       # [A, B, S, KV*D]
    conv: torch.Tensor    # [C, B, L - 1, dim]


def rope_half(x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> torch.Tensor:
    """HF's rotation of x [B, t, H, D]: pairs (i, i + D/2) turned by the
    angles whose (cos, sin) are [t, D] f32 (each half's angles twice), as
    ``x cos + rotate_half(x) sin``; f32 out."""
    x1, x2 = x.chunk(2, dim=-1)
    turned = torch.cat([-x2, x1], dim=-1)
    return x * cos[:, None] + turned * sin[:, None]


class Norm(RMSNorm):
    """``RMSNorm``'s parameter under HF's name, computed by one
    ``F.rms_norm`` call in x's dtype (f32 inside): the residual stream's
    norms return f32, the per-head q and k norms the compute dtype."""

    def forward(self, x):
        return F.rms_norm(x, self.weight.shape, self.weight.to(x.dtype),
                          self.eps)


class ShortConv(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig, device=None):
        super().__init__()
        d, n = cfg.hidden_size, cfg.conv_L_cache
        if cfg.conv_bias:
            raise NotImplementedError("LFM2 conv_bias=True")
        self.in_proj = nn.Linear(d, 3 * d, bias=False, device=device)
        self.conv = nn.Conv1d(d, d, n, groups=d, padding=n - 1, bias=False,
                              device=device)
        self.out_proj = nn.Linear(d, d, bias=False, device=device)

    def forward(self, h, state, cdt):
        """h [B, t, dim] (normed); ``state`` [B, L - 1, dim]: ``B * u`` of
        the L - 1 positions before h (zeros before the first), overwritten
        IN PLACE with those of h's last L - 1."""
        b, c, u = linear(h, self.in_proj, cdt).chunk(3, dim=-1)
        full = torch.cat([state, b * u], dim=1)
        t, taps = h.shape[1], self.conv.weight[:, 0].to(full.dtype)
        v = (full.unfold(1, taps.shape[-1], 1) * taps).sum(-1)   # [B, t, dim]
        state.copy_(full[:, t:])
        return linear(c * v, self.out_proj, cdt)


class Lfm2Attention(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig, device=None):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        e_kv = cfg.num_key_value_heads * hd
        self.n_heads, self.n_kv, self.head_dim = (
            cfg.num_attention_heads, cfg.num_key_value_heads, hd)
        self.q_proj = nn.Linear(d, cfg.num_attention_heads * hd, bias=False,
                                device=device)
        self.k_proj = nn.Linear(d, e_kv, bias=False, device=device)
        self.v_proj = nn.Linear(d, e_kv, bias=False, device=device)
        self.out_proj = nn.Linear(cfg.num_attention_heads * hd, d,
                                  bias=False, device=device)
        self.q_layernorm = Norm(hd, cfg.norm_eps, device)
        self.k_layernorm = Norm(hd, cfg.norm_eps, device)

    def forward(self, h, k_cache, v_cache, length: int, rope, cdt):
        """h [B, t, dim] (normed) at positions [length, length + t);
        ``k_cache``, ``v_cache`` [B, S, KV*D], written IN PLACE at those
        rows; ``rope`` their (cos, sin) [t, D]. Causal over rows [0,
        length + t)."""
        bsz, t, _ = h.shape
        hd, end = self.head_dim, length + t
        q = self.q_layernorm(linear(h, self.q_proj, cdt).view(bsz, t, -1, hd))
        k = self.k_layernorm(linear(h, self.k_proj, cdt).view(bsz, t, -1, hd))
        v = linear(h, self.v_proj, cdt)
        q, k = rope_half(torch.cat([q, k], dim=2), *rope).to(cdt).split(
            [self.n_heads, self.n_kv], dim=2)
        k_cache[:, length:end] = k.reshape(bsz, t, -1)
        v_cache[:, length:end] = v
        heads = lambda c: c[:, :end].view(bsz, end, -1, hd).transpose(1, 2)
        mask = None
        if t > 1:
            mask = (torch.arange(end, device=h.device)[None]
                    <= torch.arange(length, end, device=h.device)[:, None])
        y = F.scaled_dot_product_attention(
            q.transpose(1, 2), heads(k_cache), heads(v_cache),
            attn_mask=mask, scale=hd ** -0.5, enable_gqa=True)
        return linear(y.transpose(1, 2).reshape(bsz, t, -1), self.out_proj,
                      cdt)


class Lfm2Layer(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig, index: int, device=None,
                 dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.operator_norm = Norm(d, cfg.norm_eps, device)
        self.ffn_norm = Norm(d, cfg.norm_eps, device)
        if cfg.layer_types[index] == "full_attention":
            self.self_attn = Lfm2Attention(cfg, device)
        else:
            self.conv = ShortConv(cfg, device)
        if index < cfg.num_dense_layers:
            self.feed_forward = SwiGLU(d, cfg.intermediate_size, device,
                                       dtype)
        else:
            self.feed_forward = RoutedExperts(
                d, cfg.moe_intermediate_size, cfg.num_experts,
                cfg.num_experts_per_tok,
                use_expert_bias=cfg.use_expert_bias,
                norm_topk_prob=cfg.norm_topk_prob,
                routed_scaling=cfg.routed_scaling_factor, layer=index,
                device=device, dtype=dtype)

    def forward(self, x, state, length: int, rope, cdt):
        """x [B, t, dim] f32 (the residual stream); ``state`` this layer's
        (k, v) cache segments or its conv state. The feed-forward takes the
        f32 norm (the router reads it as it is; the products cast it)."""
        h = self.operator_norm(x).to(cdt)
        if hasattr(self, "self_attn"):
            with span("lfm2.attn"):
                y = self.self_attn(h, state[0], state[1], length, rope, cdt)
        else:
            with span("lfm2.conv"):
                y = self.conv(h, state, cdt)
        x = x + y
        return x + self.feed_forward(self.ffn_norm(x))


class StepGraphs:
    """CUDA graphs of ``Lfm2._step``: a decode step launches about 900
    small kernels, which the host would issue one by one.

    The graphs own the decode state. For each cache shape (rows, length
    of the cache, dtype) they hold one token, one ``HybridCache`` and one
    logits buffer [rows, V] f32; a cache that is not the held one is
    copied into it once, and ``decode_step`` hands the held cache back,
    so the steps after it and the in-place ``reorder_cache`` run on it
    with no copy. So one decode at a time per shape; the logits are the
    held buffer, valid until the next step. Each position is captured the
    first time it comes (after one step on a side stream, with the conv
    state put back, to warm the libraries up), into one memory pool. A
    replay adds the launches its capture recorded to the counters of
    ``COUNTERS`` (the grouped products, the route and combine kernels)."""

    COUNTERS = ((moe, "grouped_calls"), (moe_route, "launches"),
                (moe_route, "combine_launches"))

    def __init__(self):
        self.held = {}        # shape -> (token, HybridCache, logits)
        self.graphs = {}      # (shape, position) -> (graph, launches)
        self.pool = None

    def step(self, model, token, cache: HybridCache, length: int):
        shape = (token.shape[0], cache.k.shape, cache.conv.shape,
                 cache.k.dtype, token.device)
        if shape not in self.held:
            self.held[shape] = (
                torch.empty_like(token),
                HybridCache(*(torch.empty_like(t) for t in cache)),
                torch.empty(token.shape[0], model.cfg.vocab_size,
                            device=token.device))
        tok, held, logits = self.held[shape]
        if any(a.data_ptr() != b.data_ptr() for a, b in zip(held, cache)):
            for mine, theirs in zip(held, cache):
                mine.copy_(theirs)
        tok.copy_(token)
        if (shape, length) not in self.graphs:
            self.graphs[shape, length] = self._capture(model, tok, held,
                                                       logits, length)
        graph, calls = self.graphs[shape, length]
        graph.replay()
        for (mod, name), n in zip(self.COUNTERS, calls):
            setattr(mod, name, getattr(mod, name) + n)
        return logits, held

    def _capture(self, model, tok, held, logits, length):
        conv = held.conv.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model._step(tok, held, length)
        torch.cuda.current_stream().wait_stream(side)
        held.conv.copy_(conv)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = [getattr(mod, name) for mod, name in self.COUNTERS]
        with torch.cuda.graph(graph, pool=self.pool):
            logits.copy_(model._step(tok, held, length))
        calls = []
        for (mod, name), was in zip(self.COUNTERS, before):
            calls.append(getattr(mod, name) - was)
            setattr(mod, name, was)
        return graph, calls


class Lfm2(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig, device=None, dtype=None):
        super().__init__()
        if not cfg.tie_word_embeddings:
            raise NotImplementedError("LFM2 with an untied head")
        self.cfg = cfg
        self.compute_dtype = dtype
        self.model = nn.Module()
        self.model.embed_tokens = nn.Embedding(cfg.vocab_size,
                                               cfg.hidden_size, device=device)
        self.model.layers = nn.ModuleList(
            Lfm2Layer(cfg, i, device, dtype)
            for i in range(cfg.num_hidden_layers))
        self.model.embedding_norm = Norm(cfg.hidden_size, cfg.norm_eps,
                                         device)
        self._graphs = StepGraphs()

    @property
    def dtype(self) -> torch.dtype:
        return self.model.embed_tokens.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def _cdt(self) -> torch.dtype:
        return self.compute_dtype or self.dtype

    def _rope_rows(self, length: int, t: int):
        """(cos, sin) [t, D] f32 of positions [length, length + t) (each
        half's angles twice), computed at each call: a captured step reads
        no table that a longer sequence could replace."""
        hd, dev = self.cfg.head_dim, self.device
        inv = 1.0 / (self.cfg.rope_theta ** (torch.arange(
            0, hd, 2, dtype=torch.float32, device=dev) / hd))
        ang = torch.arange(length, length + t, dtype=torch.float32,
                           device=dev)[:, None] * inv
        ang = torch.cat([ang, ang], dim=-1)
        return torch.cos(ang), torch.sin(ang)

    def init_decode_cache(self, batch: int, max_len: int) -> HybridCache:
        c = self.cfg
        kv = (len(c.attention_layers), batch, max_len,
              c.num_key_value_heads * c.head_dim)
        conv = (c.num_hidden_layers - len(c.attention_layers), batch,
                c.conv_L_cache - 1, c.hidden_size)
        z = lambda shape: torch.zeros(shape, dtype=self._cdt(),
                                      device=self.device)
        return HybridCache(z(kv), z(kv), z(conv))

    def _embed_in(self, idx, prefix):
        """The residual stream's start, f32: ``prefix`` then the tokens'
        embeddings."""
        x = self.model.embed_tokens(idx)
        if prefix is not None:
            x = torch.cat([prefix.to(x.dtype), x], dim=1)
        return x.float()

    def _run_layers(self, x, cache: HybridCache, length: int):
        """x [B, t, dim] through every layer at positions [length, length +
        t), reading and writing ``cache`` IN PLACE."""
        rope = self._rope_rows(length, x.shape[1])
        cdt, a, c = self._cdt(), 0, 0
        for layer in self.model.layers:
            if hasattr(layer, "self_attn"):
                state, a = (cache.k[a], cache.v[a]), a + 1
            else:
                state, c = cache.conv[c], c + 1
            x = layer(x, state, length, rope, cdt)
        return x

    def _head(self, x):
        """The tied head: f32 logits of the final-normed states rounded to
        the compute dtype, over the table as it is stored, summed in f32
        (on the card one bf16 product with an f32 output)."""
        h = self.model.embedding_norm(x).to(self._cdt())
        w = self.model.embed_tokens.weight
        if h.dtype == torch.float32 or not h.is_cuda:
            return h.float() @ w.float().t()
        out = torch.mm(h.reshape(-1, h.shape[-1]), w.to(h.dtype).t(),
                       out_dtype=torch.float32)
        return out.view(*h.shape[:-1], -1)

    def logits(self, idx, prefix=None):
        """f32 logits [B, Tw, V] over the text positions of ``idx`` [B, Tw]
        after the soft prompt ``prefix`` [B, P, dim] (or None)."""
        x = self._embed_in(idx, prefix)
        cache = self.init_decode_cache(x.shape[0], x.shape[1])
        x = self._run_layers(x, cache, 0)
        return self._head(x[:, -idx.shape[1]:])

    @torch.no_grad()
    def prefill(self, idx, prefix, cache: HybridCache):
        """The prompt (prefix + ``idx``) once through the layers, filling
        the cache's rows [0, t) and the conv state IN PLACE. Returns
        (logits_last [B, V] f32, cache, t)."""
        x = self._embed_in(idx, prefix)
        x = self._run_layers(x, cache, 0)
        return self._head(x[:, -1:])[:, 0], cache, x.shape[1]

    @torch.no_grad()
    def decode_step(self, token, cache: HybridCache, length: int,
                    qweights: Optional[dict] = None):
        """token [B] at position ``length`` through the module layers: on
        the card a replay of the step's CUDA graph on the state the graphs
        hold (``StepGraphs``), the layers themselves while a profiler
        records (their spans need the host's launches) and on the CPU.
        Returns (logits [B, V] f32, cache, length + 1): carry on with the
        cache returned, which on the card is the held one."""
        if qweights is not None:
            raise NotImplementedError(
                "LFM2 decodes its module layers and takes no stacked decode "
                "weights")
        if token.is_cuda and not _profiler_enabled():
            logits, cache = self._graphs.step(self, token, cache, length)
        else:
            logits = self._step(token, cache, length)
        return logits, cache, length + 1

    def _step(self, token, cache: HybridCache, length: int):
        x = self.model.embed_tokens(token).float()[:, None]
        return self._head(self._run_layers(x, cache, length))[:, 0]

    def decode_weights(self, int8_weights: bool):
        """No stacked decode weights (``sampling.decode_weights``): the
        fused decode kernels (K2, K5) take a dense transformer block, and
        w8a16 is their mode."""
        if int8_weights:
            raise NotImplementedError(
                "int8 decode weights (w8a16) are a mode of the fused decode "
                "kernels K2 / K5, which run no LFM2 layer (short "
                "convolutions, routed experts); serve with "
                "int8_weights=False")
        return None

    @staticmethod
    def reorder_cache(cache: HybridCache, flat_idx, group: int = 0):
        """Gather the decode state to a new (beam) order IN PLACE, so the
        state the step's graphs hold stays theirs: the (k, v) sides as
        ``GPT.reorder_cache`` does (kernel K3 when ``group`` > 0), the
        conv state by the same rows. Returns ``cache``."""
        k, v = GPT.reorder_cache((cache.k, cache.v), flat_idx, group)
        moved = (k, v, cache.conv.index_select(1, flat_idx))
        for mine, new in zip(cache, moved):
            if new.data_ptr() != mine.data_ptr():
                mine.copy_(new)
        return cache

    @staticmethod
    def expand_cache(cache: HybridCache, w: int) -> HybridCache:
        """Replicate a batch-B state to B*W beam rows, each sentence's W
        beams adjacent."""
        return HybridCache(*(t.repeat_interleave(w, dim=1) for t in cache))
