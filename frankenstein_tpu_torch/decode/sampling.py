"""KV-cached top-k sampling, greedy decoding and batched beam search
(``frankenstein_tpu/decode/sampling.py``).

One prefill fills a fixed-shape cache, then each token costs one
``decode_step`` (kernel K2 for GPT-2, K5 for a LLaMA, on the card), or
with ``COMPACT_TOPK`` one ``decode_step_topk`` (K2, then K8's head and
top-k).
Beams are vectorized into the batch: a W-beam search over B sentences is
one [B*W] decode whose cache rows are regathered by parent beam every step
(kernel K3 on the card).
``int8_kv=True`` quantizes the cache to int8 right after prefill.

A seq2seq model (whisper) prefills itself (encoder, cross K/V, prompt) and
hands its state to ``greedy_decode_scan`` or ``beam_from_prefill``, which
take a model with ``decode_step`` and, for beams, its own
``expand_cache`` / ``reorder_cache``.

Under a profiler the prefill is a ``decode.prefill`` span and every token
a ``decode.step`` span holding ``decode.select`` (the pick, or the beams'
scores and top-k), ``decode.reorder`` (beams: K3 and the histories) and
``decode.forward`` (the model's step); beams end in ``decode.rank``
(``utils/profiling.py:span``).

Randomness comes from a ``torch.Generator``; top-k is exact (the JAX
package draws its candidates with ``approx_max_k``, which is exact off the
TPU), so deterministic beams match the JAX package token for token, and
sampled tokens match it in distribution only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from frankenstein_tpu_torch.utils.profiling import span

NEG_INF = -1e30

# Route top-k sampling through the model's compact ``decode_step_topk``
# (Franky: ln_f + the tied head + top-k + the exact logsumexp in kernel K8)
# where it can: the [B, vocab] logits never exist in the loop. Read at each
# call of ``generate``. Off by default, as in the JAX package, whose TPU
# measurement found the compact route slightly slower there; the port's
# default waits for its own measurement. A top-k request takes it when the
# switch is on, top_k < vocab, not greedy, the model has the method, and
# the decode weights are not int8 (``decode_step_topk`` has no w8a16
# contract, so w8a16 requests keep the dense route).
COMPACT_TOPK = False


def _round_cache_len(n: int, mult: int = 16) -> int:
    """Round the KV-cache length up to a multiple of ``mult``; padding rows
    are masked out."""
    return -(-n // mult) * mult


def decode_weights(model, int8_weights: bool) -> dict:
    """The stacked decode weights the model's decode kernel streams (K2 for
    a GPT, K5 for a LLaMA, either possibly under a composite's
    ``llm_model``): in the model's dtype, or w8a16 int8 codes with
    per-(layer, out-lane) scales. An MoE LM has none (None: its decode
    steps run the module blocks), and int8 weights raise for it, as the JAX
    package's do off its fused path. Any other LM answers for itself
    (``decode_weights(int8_weights)``, LFM2's None), and one without that
    method raises."""
    from frankenstein_tpu_torch.models import gpt2, llama
    lm = model.llm_model if hasattr(model, "llm_model") else model
    if not isinstance(lm, (gpt2.GPT, llama.Llama)):
        if not hasattr(lm, "decode_weights"):
            raise TypeError(f"no stacked decode weights for a "
                            f"{type(lm).__name__}: a GPT, a Llama or an LM "
                            "with its own decode_weights(int8_weights)")
        return lm.decode_weights(int8_weights)
    family = llama if isinstance(lm, llama.Llama) else gpt2
    lm.refuse_tp("decode_weights")
    if lm.cfg.moe_experts > 0 and not int8_weights:
        return None
    if int8_weights:
        return family.quantize_decode_weights(lm, lm.dtype)
    return family.stack_decode_weights(lm)


def quantize_serving_weights(model) -> dict:
    """Precompute the w8a16 decode weights ONCE for a serving loop; pass the
    result as ``qweights=`` to ``generate``."""
    return decode_weights(model, int8_weights=True)


def _pick(logits, generator, *, temperature: float, top_k: Optional[int],
          greedy: bool):
    logits = logits.float() / temperature
    if greedy:
        return torch.argmax(logits, dim=-1)
    if top_k is not None and top_k < logits.shape[-1]:
        vals, idx = torch.topk(logits, top_k, dim=-1)
        choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                                   generator=generator)
        return torch.gather(idx, -1, choice)[:, 0]
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


def _compact(model, logits, qweights: dict, top_k: Optional[int],
             greedy: bool) -> bool:
    """Whether ``_sample_scan`` takes the compact route (``COMPACT_TOPK``'s
    conditions, the JAX ``_sample_scan``'s)."""
    return (COMPACT_TOPK and top_k is not None and top_k < logits.shape[-1]
            and not greedy and hasattr(type(model), "decode_step_topk")
            and (qweights is None or qweights["qkv_w"].dtype != torch.int8))


@torch.no_grad()
def _sample_scan(model, logits, cache, length: int, generator, *,
                 qweights: dict, max_new_tokens: int,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 greedy: bool = False):
    """Draw a token from ``logits``, step the model, repeat. Returns
    [B, max_new_tokens] int64 ids."""
    if _compact(model, logits, qweights, top_k, greedy):
        return _sample_scan_topk(model, logits, cache, length, generator,
                                 qweights=qweights,
                                 max_new_tokens=max_new_tokens,
                                 temperature=temperature, top_k=top_k)
    toks = []
    for _ in range(max_new_tokens):
        with span("decode.step"):
            with span("decode.select"):
                tok = _pick(logits, generator, temperature=temperature,
                            top_k=top_k, greedy=greedy)
            toks.append(tok)
            with span("decode.forward"):
                logits, cache, length = model.decode_step(tok, cache,
                                                          length, qweights)
    return torch.stack(toks, dim=1)


def _sample_scan_topk(model, logits, cache, length: int, generator, *,
                      qweights: dict, max_new_tokens: int,
                      temperature: float, top_k: int):
    """Top-k sampling over the model's compact (vals, idx) decode step: the
    first draw from the prefill logits' exact top-k, then each step draws
    ``multinomial(softmax(vals / temperature))`` and takes ``idx`` at the
    choice, the same draw as ``_pick``'s (dividing by the temperature
    commutes with taking the top-k)."""
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk
    vals, idx = lm_head_topk.exact_topk(logits.float(), top_k)
    toks = []
    for _ in range(max_new_tokens):
        with span("decode.step"):
            with span("decode.select"):
                choice = torch.multinomial(
                    torch.softmax(vals / temperature, dim=-1), 1,
                    generator=generator)
                tok = torch.gather(idx, -1, choice)[:, 0]
            toks.append(tok)
            with span("decode.forward"):
                vals, idx, _, cache, length = model.decode_step_topk(
                    tok, cache, length, qweights, k=top_k)
    return torch.stack(toks, dim=1)


def _prefill(model, idx0, prefix, max_new_tokens: int, int8_kv: bool):
    """Prefill a fresh cache sized for ``max_new_tokens`` more tokens; with
    ``int8_kv`` the cache becomes a ``QuantCache``. Returns (logits, cache,
    length)."""
    from frankenstein_tpu_torch.models import gpt2
    max_len = _round_cache_len(
        idx0.shape[1] + (prefix.shape[1] if prefix is not None else 0)
        + max_new_tokens + 1)
    with span("decode.prefill"):
        cache = model.init_decode_cache(idx0.shape[0], max_len)
        logits, cache, length = model.prefill(idx0, prefix, cache)
        if int8_kv:
            cache = gpt2.quantize_cache(cache)
    return logits, cache, length


@torch.no_grad()
def generate(model, idx0, prefix, generator=None, *, max_new_tokens: int,
             temperature: float = 1.0, top_k: Optional[int] = None,
             greedy: bool = False, int8_kv: bool = False,
             int8_weights: bool = False, qweights: Optional[dict] = None):
    """Top-k sampling (or greedy) with a KV cache.

    idx0: [B, T0] prompt ids; prefix: [B, P, n_embd] soft prompt or None.
    ``int8_kv=True`` quantizes the prefilled cache to int8 (fixed
    per-(layer, lane) scales, ``models.gpt2.QuantCache``).
    ``int8_weights=True`` streams w8a16 weights, quantized here unless a
    precomputed ``qweights`` is given. Returns [B, max_new_tokens]."""
    logits, cache, length = _prefill(model, idx0, prefix, max_new_tokens,
                                     int8_kv)
    if qweights is None:
        qweights = decode_weights(model, int8_weights)
    return _sample_scan(model, logits, cache, length, generator,
                        qweights=qweights, max_new_tokens=max_new_tokens,
                        temperature=temperature, top_k=top_k, greedy=greedy)


def _tree_map(fn, cache):
    """``fn`` over every tensor of a (nested) tuple, list or NamedTuple."""
    if isinstance(cache, torch.Tensor):
        return fn(cache)
    leaves = [_tree_map(fn, c) for c in cache]
    return type(cache)(*leaves) if hasattr(cache, "_fields") \
        else type(cache)(leaves)


def _reorder(model, cache, flat_idx, group: int = 0):
    """Gather cache rows to the surviving-beam order. The model owns its
    cache layout (``reorder_cache``); ``group`` is the beam width when the
    indices never leave their sentence's w-row block (GPT then reorders
    through kernel K3). Without ``reorder_cache``, batch is axis 0."""
    reorder = getattr(type(model), "reorder_cache", None)
    if reorder is not None:
        return reorder(cache, flat_idx, group=group)
    return _tree_map(lambda c: c.index_select(0, flat_idx), cache)


def _freeze_finished(logp, finished, pad_id: int):
    """Rows of finished beams get a single continuation: pad with logp 0,
    so the beam's score and its content after EOS are frozen."""
    pad_row = torch.full((logp.shape[-1],), NEG_INF, dtype=logp.dtype,
                         device=logp.device)
    pad_row[pad_id] = 0.0
    return torch.where(finished[:, None], pad_row[None], logp)


def _beam_state(b: int, w: int, max_new_tokens: int, device):
    """Beams 1..w-1 start dead, so the first expansion draws w distinct
    tokens. Returns (scores, finished, gen_len, toks)."""
    scores = torch.tensor([0.0] + [NEG_INF] * (w - 1),
                          device=device).repeat(b)
    return (scores, torch.zeros(b * w, dtype=torch.bool, device=device),
            torch.zeros(b * w, dtype=torch.int32, device=device),
            torch.zeros(b * w, max_new_tokens, dtype=torch.long,
                        device=device))


def _beam_advance(model, cache, flat_parent, token_flat, i: int, toks,
                  finished, gen_len, w: int, eos_id: Optional[int]):
    """Move cache, history and EOS state to the surviving beams and append
    their tokens at step ``i``."""
    cache = _reorder(model, cache, flat_parent, group=w)
    toks = toks[flat_parent]
    toks[:, i] = token_flat
    if eos_id is not None:
        parent_fin = finished[flat_parent]
        parent_len = gen_len[flat_parent]
        finished = parent_fin | (token_flat == eos_id)
        gen_len = torch.where(parent_fin, parent_len,
                              torch.full_like(parent_len, i + 1))
    return cache, toks, finished, gen_len


def _rank(toks, scores, finished, gen_len, b: int, w: int,
          max_new_tokens: int, eos_id: Optional[int], length_penalty: float,
          n_best: bool):
    """Final ranking by ``score / gen_len**length_penalty`` (gen_len counts
    tokens up to and including EOS; unfinished beams count max_new_tokens).
    Returns the best beam (tokens [B, T], scores [B]) or, with ``n_best``,
    all W best-first ([B, W, T], [B, W])."""
    scores = scores.reshape(b, w)
    if length_penalty != 0.0:
        if eos_id is not None:
            eff_len = torch.where(finished, gen_len,
                                  torch.full_like(gen_len, max_new_tokens))
        else:
            eff_len = torch.full_like(gen_len, max_new_tokens)
        scores = scores / (eff_len.reshape(b, w).float() ** length_penalty)
    toks = toks.reshape(b, w, max_new_tokens)
    if n_best:
        order = torch.argsort(-scores, dim=-1, stable=True)
        return (torch.gather(toks, 1, order[..., None].expand_as(toks)),
                torch.gather(scores, 1, order))
    best = torch.argmax(scores, dim=-1)
    rows = torch.arange(b, device=scores.device)
    return toks[rows, best], scores[rows, best]


@torch.no_grad()
def beam_search(model, idx0, prefix, *, max_new_tokens: int,
                beam_width: int = 3, length_normalize: bool = False,
                eos_id: Optional[int] = None, pad_id: Optional[int] = None,
                length_penalty: float = 0.0, int8_kv: bool = False,
                int8_weights: bool = False, qweights: Optional[dict] = None,
                n_best: bool = False):
    """Deterministic batched beam search. When ``eos_id`` is given, a beam
    that emits it is FROZEN: it stops accumulating log-prob and emits
    ``pad_id`` (default: eos_id) for the remaining steps. Final ranking
    divides by ``gen_len**length_penalty`` (``_rank``).

    The prompt and prefix are replicated W times BEFORE prefill, so each
    sentence's W beams are adjacent rows and int8 scales are taken over the
    B*W rows, as in the JAX package. Returns (tokens [B, max_new_tokens],
    scores [B]) of the best beam; with ``n_best=True`` all W hypotheses
    best-first ([B, W, max_new_tokens], [B, W])."""
    b, w = idx0.shape[0], beam_width
    rep = lambda x: x.repeat_interleave(w, dim=0) if x is not None else None
    if length_normalize:           # legacy alias: plain 1/len normalization
        length_penalty = 1.0
    logits, cache, length = _prefill(model, rep(idx0), rep(prefix),
                                     max_new_tokens, int8_kv)
    if qweights is None:
        qweights = decode_weights(model, int8_weights)
    return _beam_scan(model, logits, cache, length, b, qweights=qweights,
                      max_new_tokens=max_new_tokens, beam_width=w,
                      eos_id=eos_id,
                      pad_id=eos_id if pad_id is None else pad_id,
                      length_penalty=length_penalty, n_best=n_best)


def _beam_expand(model, logits, cache, w: int):
    """Replicate a batch-B prefilled decode state to B*W beam rows (each
    sentence's W beams adjacent). By default every cache tensor has batch
    at axis 0; a model whose cache differs provides
    ``expand_cache(cache, w)``."""
    rep = lambda x: x.repeat_interleave(w, dim=0)
    expand = getattr(type(model), "expand_cache", None)
    return (rep(logits),
            expand(cache, w) if expand is not None else _tree_map(rep, cache))


@torch.no_grad()
def beam_from_prefill(model, logits, cache, length: int, *,
                      max_new_tokens: int, beam_width: int = 5,
                      eos_id: Optional[int] = None,
                      pad_id: Optional[int] = None,
                      length_penalty: float = 1.0, n_best: bool = False):
    """Deterministic beam search from a decode state prefilled ONCE at batch
    B, replicated here to B*W beams (``_beam_expand``). Ranking divides by
    ``gen_len**length_penalty`` (1.0 by default, as HF's
    ``generate(num_beams=...)``). Returns (tokens [B, max_new_tokens],
    scores [B])."""
    b = logits.shape[0]
    logits, cache = _beam_expand(model, logits, cache, beam_width)
    return _beam_scan(model, logits, cache, length, b, qweights=None,
                      max_new_tokens=max_new_tokens, beam_width=beam_width,
                      eos_id=eos_id,
                      pad_id=eos_id if pad_id is None else pad_id,
                      length_penalty=length_penalty, n_best=n_best)


@torch.no_grad()
def _beam_scan(model, logits, cache, length: int, b: int, *,
               qweights: Optional[dict], max_new_tokens: int,
               beam_width: int, eos_id: Optional[int],
               pad_id: Optional[int], length_penalty: float,
               n_best: bool = False):
    w = beam_width
    vocab = logits.shape[-1]
    scores, finished, gen_len, toks = _beam_state(b, w, max_new_tokens,
                                                  logits.device)
    group = torch.arange(b, device=logits.device)[:, None] * w
    for i in range(max_new_tokens):
        with span("decode.step"):
            with span("decode.select"):
                logp = torch.log_softmax(logits.float(), dim=-1)
                if eos_id is not None:
                    logp = _freeze_finished(logp, finished, pad_id)
                total = (scores[:, None] + logp).reshape(b, w * vocab)
                top_scores, top_idx = torch.topk(total, w, dim=-1)  # [B, W]
                flat_parent = (group + top_idx // vocab).reshape(-1)
                token_flat = (top_idx % vocab).reshape(-1)
            with span("decode.reorder"):
                cache, toks, finished, gen_len = _beam_advance(
                    model, cache, flat_parent, token_flat, i, toks,
                    finished, gen_len, w, eos_id)
            with span("decode.forward"):
                logits, cache, length = model.decode_step(
                    token_flat, cache, length, qweights)
            scores = top_scores.reshape(-1)
    with span("decode.rank"):
        return _rank(toks, scores, finished, gen_len, b, w, max_new_tokens,
                     eos_id, length_penalty, n_best)


@torch.no_grad()
def sampled_beam_search(model, idx0, prefix, generator=None, *,
                        max_new_tokens: int, beam_width: int = 5,
                        topk: int = 20, temperature: float = 1.0,
                        eos_id: Optional[int] = None,
                        pad_id: Optional[int] = None,
                        length_penalty: float = 0.0, int8_kv: bool = False,
                        int8_weights: bool = False,
                        qweights: Optional[dict] = None,
                        n_best: bool = False):
    """Stochastic beam search: each beam draws ``beam_width`` candidates
    without replacement from its top-``topk`` distribution (Gumbel top-k),
    and the best W of the W*W survive. EOS handling and ranking as in
    ``beam_search``. Returns as ``beam_search``."""
    b, w = idx0.shape[0], beam_width
    rep = lambda x: x.repeat_interleave(w, dim=0) if x is not None else None
    logits, cache, length = _prefill(model, rep(idx0), rep(prefix),
                                     max_new_tokens, int8_kv)
    if qweights is None:
        qweights = decode_weights(model, int8_weights)
    return _sampled_beam_scan(model, logits, cache, length, generator, b,
                              qweights=qweights,
                              max_new_tokens=max_new_tokens, beam_width=w,
                              topk=topk, temperature=temperature,
                              eos_id=eos_id,
                              pad_id=eos_id if pad_id is None else pad_id,
                              length_penalty=length_penalty, n_best=n_best)


@torch.no_grad()
def _sampled_beam_scan(model, logits, cache, length: int, generator, b: int,
                       *, qweights: Optional[dict], max_new_tokens: int,
                       beam_width: int, topk: int, temperature: float,
                       eos_id: Optional[int], pad_id: Optional[int],
                       length_penalty: float, n_best: bool = False):
    w = beam_width
    scores, finished, gen_len, toks = _beam_state(b, w, max_new_tokens,
                                                  logits.device)
    group = torch.arange(b, device=logits.device)[:, None] * w
    for i in range(max_new_tokens):
        with span("decode.step"):
            with span("decode.select"):
                logp = torch.log_softmax(logits.float() / temperature,
                                         dim=-1)
                if eos_id is not None:
                    logp = _freeze_finished(logp, finished, pad_id)
                top_logp, top_tok = torch.topk(logp, topk, dim=-1)  # [B*W, K]
                gumbel = -torch.empty_like(top_logp).exponential_(
                    generator=generator).log()
                pick = torch.topk(top_logp + gumbel, w,
                                  dim=-1).indices                 # [B*W, W]
                cand_logp = torch.gather(top_logp, -1, pick)
                cand_tok = torch.gather(top_tok, -1, pick)
                total = (scores[:, None] + cand_logp).reshape(b, w * w)
                top_scores, top_idx = torch.topk(total, w, dim=-1)  # [B, W]
                flat_parent = (group + top_idx // w).reshape(-1)
                token_flat = torch.gather(cand_tok.reshape(b, w * w), -1,
                                          top_idx).reshape(-1)
            with span("decode.reorder"):
                cache, toks, finished, gen_len = _beam_advance(
                    model, cache, flat_parent, token_flat, i, toks,
                    finished, gen_len, w, eos_id)
            with span("decode.forward"):
                logits, cache, length = model.decode_step(
                    token_flat, cache, length, qweights)
            scores = top_scores.reshape(-1)
    with span("decode.rank"):
        return _rank(toks, scores, finished, gen_len, b, w, max_new_tokens,
                     eos_id, length_penalty, n_best)


@torch.no_grad()
def greedy_decode_scan(model, logits, cache, length: int, *,
                       max_new_tokens: int) -> torch.Tensor:
    """Greedy KV-cached decode from a prefilled state, for any model with
    ``decode_step(token, cache, length) -> (logits, cache, length)``: the
    argmax of the prefill ``logits`` first, then ``max_new_tokens - 1``
    cached steps. Returns [B, max_new_tokens] ids."""
    toks = [torch.argmax(logits.float(), dim=-1)]
    for _ in range(max_new_tokens - 1):
        with span("decode.step"):
            with span("decode.forward"):
                logits, cache, length = model.decode_step(toks[-1], cache,
                                                          length)
            with span("decode.select"):
                toks.append(torch.argmax(logits.float(), dim=-1))
    return torch.stack(toks, dim=1)


def trim_at_eot(tokens, eot_id: int):
    """Host-side: cut each row at the first eot."""
    out = []
    for row in np.asarray(torch.as_tensor(tokens).cpu()):
        stops = np.where(row == eot_id)[0]
        out.append(list(row[: stops[0]] if len(stops) else row))
    return out
