"""Plain float32 FrankyLfm2: Franky's brain encoder and Perceiver
(``reference/franky.py:brain``) with its 32 vectors as the soft prompt of
LFM2-MoE (HF ``lfm2_moe``, LiquidAI's LFM2-8B-A1B).

Written from the published equations, with no kernel, cache or batching
of the program and importing nothing of it:

- each layer is ``h = x + op(operator_norm(x))``, then ``out = h +
  ffn(ffn_norm(h))``, RMSNorm at ``norm_eps``;
- a conv ``op``: ``[B, C, u] = split3(in_proj(h))``, ``v`` the depthwise
  causal convolution (``conv_L_cache`` taps, no bias, zeros before the
  first position) of ``B * u``, ``out_proj(C * v)``;
- an attention ``op``: q and k RMS-normed per head, rotated by the
  half-split RoPE (HF's ``rotate_half``) at ``rope_theta``, causal GQA at
  1/sqrt(head_dim);
- the first ``num_dense_layers`` ffns are SwiGLUs ``w2(silu(w1 h) * w3
  h)``; the others route each token: ``s = sigmoid(h @ gate)``, experts
  ``topk(s + expert_bias, k)``, weights ``s`` at those over their sum plus
  1e-6, times ``routed_scaling_factor``; each expert runs the tokens that
  chose it, in a plain loop over the experts (no capacity, no sort);
- ``embedding_norm``, then the head tied to ``embed_tokens``.

``params`` maps the model's parameter names (``brain_model.*``,
``llm_model.model.*``) to float32 tensors, the routed experts stacked as
the program stores them (``gate_up_proj`` [E, dim, 2F], gate then up;
``down_proj`` [E, F, dim]). ``served_logits`` teacher-forces served
sentences; ``decode`` serves windows itself (beams or top-k, recomputing
every position at each step), which the controls use. Every matrix
product takes its operands through a ``Numerics`` (``reference/
blocks.py``); the convolution's taps, the norms and the softmax stay
float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import franky as franky_ref
from portbench.reference.blocks import FP32, Numerics, attend, linear, swiglu

EOT = 7               # LFM2's <|im_end|>: the start and the stop token
NEG_INF = float("-inf")
LM = "llm_model.model."
ROUTER_STD = 0.02     # the router's logits spread about 0.9 a token
BIAS_STD = 0.02       # moves the chosen set on about a third of the rows


def rms_norm(x, weight, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * weight


def rope_half(x, positions, head_dim: int, theta: float):
    """Rotate pairs (i, i + D/2) of x [B, T, H, D] by the angles of
    ``positions`` [T]."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=x.device) / head_dim))
    ang = positions.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def short_conv(h, params: dict, name: str, num: Numerics):
    b_, c_, u = linear(h, params, name + ".in_proj", num,
                       bias=False).chunk(3, dim=-1)
    w = params[name + ".conv.weight"]                         # [dim, 1, L]
    taps = w.shape[-1]
    v = F.conv1d((b_ * u).transpose(1, 2), w, padding=taps - 1,
                 groups=w.shape[0])[..., :h.shape[1]].transpose(1, 2)
    return linear(c_ * v, params, name + ".out_proj", num, bias=False)


def attention(h, params: dict, name: str, cfg: dict, num: Numerics):
    b, t, _ = h.shape
    n_q, n_kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["hidden_size"] // n_q
    heads = lambda y: y.reshape(b, t, -1, d)
    q = heads(linear(h, params, name + ".q_proj", num, bias=False))
    k = heads(linear(h, params, name + ".k_proj", num, bias=False))
    v = heads(linear(h, params, name + ".v_proj", num, bias=False))
    q = rms_norm(q, params[name + ".q_layernorm.weight"], cfg["norm_eps"])
    k = rms_norm(k, params[name + ".k_layernorm.weight"], cfg["norm_eps"])
    pos = torch.arange(t, device=h.device)
    q = rope_half(q, pos, d, cfg["rope_theta"])
    k = rope_half(k, pos, d, cfg["rope_theta"])
    rep = n_q // n_kv
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    y = attend(q, num.kv(k).repeat_interleave(rep, 2),
               num.kv(v).repeat_interleave(rep, 2), causal, num)
    return linear(y.reshape(b, t, -1), params, name + ".out_proj", num,
                  bias=False)


def routed_experts(h, params: dict, name: str, cfg: dict, num: Numerics):
    """The routed SwiGLU experts over h [B, T, dim], each on the tokens
    that chose it."""
    x = h.reshape(-1, h.shape[-1])
    gate = num.weight(name + ".gate.weight", params[name + ".gate.weight"])
    scores = torch.sigmoid(num.act(x) @ gate.t())
    pick = scores
    if cfg["use_expert_bias"]:
        pick = scores + params[name + ".expert_bias"]
    chosen = torch.topk(pick, cfg["num_experts_per_tok"], dim=-1).indices
    weights = torch.gather(scores, -1, chosen)
    if cfg["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    weights = weights * cfg["routed_scaling_factor"]
    gate_up, down = params[name + ".gate_up_proj"], params[name + ".down_proj"]
    out = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        a = num.act(x[rows]) @ num.weight(name + ".gate_up_proj", gate_up[e])
        g, u = a.chunk(2, dim=-1)
        y = num.act(F.silu(g) * u) @ num.weight(name + ".down_proj", down[e])
        out.index_add_(0, rows, y * weights[rows, slot][:, None])
    return out.reshape(h.shape)


def lfm2(idx, prefix, params: dict, cfg: dict, num: Numerics = FP32):
    """LFM2-MoE over [prefix; embed_tokens[idx]]; returns the final-normed
    states of the ``idx`` positions [B, T, dim]."""
    x = torch.cat([prefix, params[LM + "embed_tokens.weight"][idx]], dim=1)
    eps = cfg["norm_eps"]
    for i, kind in enumerate(cfg["layer_types"]):
        name = f"{LM}layers.{i}"
        h = rms_norm(x, params[name + ".operator_norm.weight"], eps)
        if kind == "full_attention":
            x = x + attention(h, params, name + ".self_attn", cfg, num)
        else:
            x = x + short_conv(h, params, name + ".conv", num)
        h = rms_norm(x, params[name + ".ffn_norm.weight"], eps)
        if i < cfg["num_dense_layers"]:
            x = x + swiglu(h, params, name + ".feed_forward", num)
        else:
            x = x + routed_experts(h, params, name + ".feed_forward", cfg,
                                   num)
    return rms_norm(x[:, prefix.shape[1]:],
                    params[LM + "embedding_norm.weight"], eps)


def head(h, params: dict, num: Numerics = FP32):
    """The tied head: states [..., dim] -> logits [..., V]."""
    table = params[LM + "embed_tokens.weight"]
    return num.act(h) @ num.weight("lm_head", table).t()


@torch.no_grad()
def served_logits(x, tokens, params: dict, cfg: dict,
                  num: Numerics = FP32, chunk: int = 1024):
    """The logits [B, n, V] that scored each served token: the window's
    prefix, then the start token and the first n - 1 of ``tokens`` [B, n]
    teacher-forced; row j is the distribution token j was drawn from."""
    prefix = franky_ref.brain(x, params, cfg["brain"], num, chunk)
    start = torch.full((x.shape[0], 1), EOT, dtype=torch.long,
                       device=x.device)
    idx = torch.cat([start, tokens[:, :-1]], dim=1)
    return head(lfm2(idx, prefix, params, cfg["lm"], num), params, num)


def _next_logits(idx, prefix, params: dict, cfg: dict, num: Numerics):
    return head(lfm2(idx, prefix, params, cfg, num)[:, -1], params, num)


@torch.no_grad()
def decode(x, params: dict, cfg: dict, traffic: dict, num: Numerics = FP32,
           generator=None, chunk: int = 1024):
    """Serve windows [B, T, C] as ``traffic`` asks: (tokens [B,
    max_new_tokens], scores [B]) of the best of ``beam_width`` beams, or
    (tokens, None) drawn from the top ``top_k`` with ``generator``."""
    prefix = franky_ref.brain(x, params, cfg["brain"], num, chunk)
    n, w = traffic["max_new_tokens"], traffic.get("beam_width", 0)
    if w > 1:
        return _beams(prefix, params, cfg["lm"], n, w, num)
    return _sample(prefix, params, cfg["lm"], n, traffic.get("top_k"),
                   generator, num), None


def _sample(prefix, params, cfg, n: int, top_k, generator, num):
    idx = torch.full((prefix.shape[0], 1), EOT, dtype=torch.long,
                     device=prefix.device)
    for _ in range(n):
        logits = _next_logits(idx, prefix, params, cfg, num)
        vals, ids = torch.topk(logits, top_k or logits.shape[-1], dim=-1)
        pick = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                                 generator=generator)
        idx = torch.cat([idx, torch.gather(ids, -1, pick)], dim=1)
    return idx[:, 1:]


def _beams(prefix, params, cfg, n: int, w: int, num):
    """Beam search as the served one is specified (``reference/franky.py:
    _beams``): beams 1..w-1 start dead; a beam that emits the stop token is
    frozen; the best beam has the highest summed log-probability over its
    length."""
    b, dev = prefix.shape[0], prefix.device
    prefix = prefix.repeat_interleave(w, dim=0)
    scores = torch.tensor([0.0] + [NEG_INF] * (w - 1), device=dev).repeat(b)
    finished = torch.zeros(b * w, dtype=torch.bool, device=dev)
    length = torch.zeros(b * w, dtype=torch.long, device=dev)
    idx = torch.full((b * w, 1), EOT, dtype=torch.long, device=dev)
    first = torch.arange(b, device=dev)[:, None] * w
    for i in range(n):
        logp = torch.log_softmax(_next_logits(idx, prefix, params, cfg, num),
                                 dim=-1)
        frozen = torch.full_like(logp[0], NEG_INF)
        frozen[EOT] = 0.0
        logp = torch.where(finished[:, None], frozen[None], logp)
        vocab = logp.shape[-1]
        total = (scores[:, None] + logp).reshape(b, w * vocab)
        top, at = torch.topk(total, w, dim=-1)
        parent = (first + at // vocab).reshape(-1)
        tok = (at % vocab).reshape(-1)
        idx = torch.cat([idx[parent], tok[:, None]], dim=1)
        done = finished[parent]
        length = torch.where(done, length[parent],
                             torch.full_like(length, i + 1))
        finished = done | (tok == EOT)
        scores = top.reshape(-1)
    final = scores / torch.where(finished, length,
                                 torch.full_like(length, n)).float()
    best = torch.argmax(final.reshape(b, w), dim=-1)
    rows = torch.arange(b, device=dev) * w + best
    return idx[rows, 1:], final[rows]


def n_layer(cfg: dict) -> int:
    """The depth that scales the residual projections' weights."""
    return cfg["lm"]["num_hidden_layers"]


def init_rule(name: str, shape, n_layer: int):
    """(mean, std) of the benchmark's weights for parameter ``name``: the
    brain's as Franky's (``reference/franky.py:init_rule``); in the LM,
    norms near 1, the convolution's taps at 1/sqrt(3) (lecun on its fan-in),
    the router at ``ROUTER_STD`` and the expert bias at ``BIAS_STD``, the
    projections that end a sublayer (``out_proj``, ``w2``, ``down_proj``)
    at 0.02 / sqrt(2L) and every other matrix at 0.02 (HF's
    ``initializer_range``)."""
    if not name.startswith("llm_model."):
        return franky_ref.init_rule(name, shape, n_layer)
    if "norm" in name:
        return 1.0, 0.05
    if name.endswith("expert_bias"):
        return 0.0, BIAS_STD
    if name.endswith("feed_forward.gate.weight"):
        return 0.0, ROUTER_STD
    if name.endswith("conv.conv.weight"):
        return 0.0, 1.0 / math.sqrt(shape[-1])
    if name.endswith(("out_proj.weight", "w2.weight", "down_proj")):
        return 0.0, 0.02 / math.sqrt(2 * n_layer)
    return 0.0, 0.02
