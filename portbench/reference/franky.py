"""Plain float32 Franky: the BrainFormer encoder, the Perceiver resampler
and GPT-2 (124M, OpenAI's widths) with the resampler's 32 vectors as its
soft prompt.

``params`` maps the model's parameter names (``brain_model.*``,
``llm_model.*``) to float32 tensors; the tied head is
``llm_model.transformer.wte.weight``. ``served_logits`` teacher-forces a
served sentence to score each of its tokens; ``decode`` serves windows
itself (top-k sampling or beams, recomputing every position at each step,
with no cache), which the controls use; ``loss_sum`` and ``micro_losses``
are the training objective.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.blocks import (FP32, Numerics, attend, block,
                                        layer_norm, linear, rope_table,
                                        slab_allowed, swiglu, to_patches)

EOT = 50256
IGNORE = -100
NEG_INF = float("-inf")


def encoder(x, params: dict, enc: dict, prefix: str,
            num: Numerics = FP32, chunk: int = 1024):
    """[B, T, C] window -> [B, N, dim] context: patches, their embedding
    plus the electrode embedding, slab-causal blocks with RoPE, final
    norm."""
    p = enc["patch_size"]
    tok = linear(to_patches(x, p), params, prefix + "transformer.emb", num)
    n = tok.shape[1]
    space = params[prefix + "space_embedding"][0]             # [C, dim]
    tok = tok + space.repeat(n // space.shape[0], 1)[None]
    pos = torch.arange(n, device=x.device)
    rope = rope_table(enc["head_dim"], pos, enc.get("rope_theta", 10000.0))
    tpt = enc["n_electrodes"]
    allowed_fn = lambda lo, hi: slab_allowed(pos[lo:hi], pos, tpt)
    for i in range(enc["n_layers"]):
        tok = block(tok, params, f"{prefix}transformer.h.{i}",
                    enc["n_heads"], rope, allowed_fn, num, chunk)
    return layer_norm(tok, params, prefix + "transformer.ln_f")


def brain(x, params: dict, cfg: dict, num: Numerics = FP32,
          chunk: int = 1024):
    """[B, T, C] -> the [B, n_output_tokens, output_dim] soft prompt."""
    pre = "brain_model."
    context = encoder(x, params, cfg["encoder"], pre + "encoder.", num,
                      chunk)
    b = x.shape[0]
    q = params[pre + "learnable_queries"].expand(b, -1, -1)
    nq = q.shape[1]
    rope = rope_table(cfg["head_dim"], torch.arange(nq, device=x.device),
                      cfg.get("rope_theta", 10000.0))
    h = cfg["n_heads"]
    for i in range(cfg["n_layers"]):
        name = f"{pre}perceiver.h.{i}"
        xq = layer_norm(q, params, name + ".ln_1")
        heads = lambda y: y.reshape(b, y.shape[1], h, -1)
        qq = heads(linear(xq, params, name + ".cross_attn.qw", num, False))
        kk = heads(linear(context, params, name + ".cross_attn.kw", num,
                          False))
        vv = heads(linear(context, params, name + ".cross_attn.vw", num,
                          False))
        out = attend(qq, kk, vv, None, num).reshape(b, nq, -1)
        q = q + linear(out, params, name + ".cross_attn.project", num, False)
        q = q + swiglu(layer_norm(q, params, name + ".ln_2"), params,
                       name + ".mlp", num)
        q = block(q, params, name + ".sa_block", h, rope, None, num)
    q = layer_norm(q, params, pre + "perceiver.ln_f")
    return linear(q, params, pre + "perceiver.to_words", num)


def gpt(idx, prefix, params: dict, cfg: dict, num: Numerics = FP32):
    """GPT-2 over [prefix; wte[idx]] with learned positions and causal
    attention; returns the final-norm states of the ``idx`` positions
    [B, T, E]."""
    pre = "llm_model.transformer."
    wte = params[pre + "wte.weight"]
    x = torch.cat([prefix, wte[idx]], dim=1)
    t = x.shape[1]
    x = x + params[pre + "wpe.weight"][:t][None]
    n_head = cfg["n_head"]
    b = x.shape[0]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    for i in range(cfg["n_layer"]):
        name = f"{pre}h.{i}"
        qkv = linear(layer_norm(x, params, name + ".ln_1"), params,
                     name + ".attn.c_attn", num)
        q, k, v = (y.reshape(b, t, n_head, -1) for y in qkv.chunk(3, -1))
        y = attend(q, num.kv(k), num.kv(v), causal, num).reshape(b, t, -1)
        x = x + linear(y, params, name + ".attn.c_proj", num)
        hid = F.gelu(linear(layer_norm(x, params, name + ".ln_2"), params,
                            name + ".mlp.c_fc", num), approximate="none")
        x = x + linear(hid, params, name + ".mlp.c_proj", num)
    return layer_norm(x[:, prefix.shape[1]:], params, pre + "ln_f")


def head(h, params: dict, num: Numerics = FP32):
    """The tied head: states [..., E] -> logits [..., V]."""
    wte = params["llm_model.transformer.wte.weight"]
    return num.act(h) @ num.weight("lm_head", wte).t()


@torch.no_grad()
def served_logits(x, tokens, params: dict, cfg: dict,
                  num: Numerics = FP32, chunk: int = 1024):
    """The logits [B, n, V] that scored each served token: the window's
    prefix, then <|endoftext|> and the first n - 1 of ``tokens`` [B, n]
    teacher-forced; row j is the distribution token j was drawn from."""
    prefix = brain(x, params, cfg["brain"], num, chunk)
    start = torch.full((x.shape[0], 1), EOT, dtype=torch.long,
                       device=x.device)
    idx = torch.cat([start, tokens[:, :-1]], dim=1)
    return head(gpt(idx, prefix, params, cfg["gpt"], num), params, num)


@torch.no_grad()
def decode(x, params: dict, cfg: dict, traffic: dict, num: Numerics = FP32,
           generator=None, chunk: int = 1024):
    """Serve windows [B, T, C] as ``traffic`` asks: (tokens [B,
    max_new_tokens], scores [B]) of the best of ``beam_width`` beams, or
    (tokens, None) drawn from the top ``top_k`` with ``generator``."""
    prefix = brain(x, params, cfg["brain"], num, chunk)
    n, w = traffic["max_new_tokens"], traffic.get("beam_width", 0)
    if w > 1:
        return _beams(prefix, params, cfg["gpt"], n, w, num)
    return _sample(prefix, params, cfg["gpt"], n, traffic.get("top_k"),
                   generator, num), None


def _next_logits(idx, prefix, params: dict, cfg: dict, num: Numerics):
    h = gpt(idx, prefix, params, cfg, num)
    return head(h[:, -1], params, num)


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
    """Beam search as the served one is specified: beams 1..w-1 start
    dead; a beam that emits <|endoftext|> is frozen (its one continuation
    is <|endoftext|> at log-probability 0); the best beam has the highest
    summed log-probability over its length (tokens up to and with its
    <|endoftext|>, else ``n``)."""
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


def loss_sum(x, targets, params: dict, cfg: dict, num: Numerics = FP32,
             chunk: int = 1024):
    """(summed cross-entropy, count) of rows [B] of the training objective:
    targets [B, n] with -100 padding are fed as the input ids (padding as
    <|endoftext|>), and each next kept target is scored. A batch's loss is
    the sum over the count."""
    prefix = brain(x, params, cfg["brain"], num, chunk)
    idx = torch.where(targets == IGNORE, torch.full_like(targets, EOT),
                      targets)
    logits = head(gpt(idx, prefix, params, cfg["gpt"], num), params, num)
    gold = targets[:, 1:]
    keep = gold != IGNORE
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    picked = torch.gather(logp, -1, torch.where(keep, gold, 0)[..., None])
    return -(picked[..., 0] * keep).sum(), int(keep.sum())


def micro_losses(batch, accum: int, rows: int, seed: int, step: int,
                 params: dict, cfg: dict, num: Numerics = FP32):
    """Yield (summed loss of a block of ``rows`` rows, its microbatch's
    count of scored targets) over the ``accum`` microbatches of one step's
    batch (windows, targets) on the device; the step's loss is the sum of
    each block over its count, over ``accum``."""
    x, y = batch
    micro = x.shape[0] // accum
    for lo in range(0, x.shape[0], micro):
        count = int((y[lo:lo + micro, 1:] != IGNORE).sum())
        for r in range(lo, lo + micro, rows):
            yield loss_sum(x[r:r + rows], y[r:r + rows], params, cfg,
                           num)[0], count


def n_layer(cfg: dict) -> int:
    """The depth that scales the residual projections' weights."""
    return cfg["gpt"]["n_layer"]


def init_rule(name: str, shape, n_layer: int):
    """(mean, std) of the benchmark's weights for parameter ``name``: the
    model's initialisers' scales (lecun-normal brain kernels, the electrode
    embedding at 1, GPT-2's normal(0.02) and its residual projections at
    0.02 / sqrt(2L)), with norms near 1 and biases and the learnable
    queries near 0 but not equal to them, so that the comparison covers
    every parameter."""
    if name.endswith("bias"):
        return 0.0, 0.02
    if ".ln_" in name or ".ln_f" in name:
        return 1.0, 0.05
    if name.endswith("space_embedding"):
        return 0.0, 1.0
    if name.endswith("learnable_queries"):
        return 0.0, 0.02
    if name.startswith("llm_model."):
        if name.endswith("c_proj.weight"):
            return 0.0, 0.02 / math.sqrt(2 * n_layer)
        return 0.0, 0.02
    return 0.0, 1.0 / math.sqrt(shape[1])
