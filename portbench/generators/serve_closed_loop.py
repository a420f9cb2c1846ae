"""Closed-loop serving: one caller sends its next ``predict()`` call when
the last one has returned its strings, as an evaluation or submission
script does.

Set-up builds the served model from the configuration through the
program's own entry (``programs/<model>.py``: ``make_franky_predictor``),
loads the benchmark's weights (drawn from the seed, in the served dtype),
makes a pool of float32 host windows from the seed (each request pays its
host-to-device copy, as a submission does) and warms up two calls of the
cell's shape. The window then sends back-to-back requests for ``seconds``,
times each from the call until its strings are back and the device has
finished (host clock), and counts every sentence the requests completed
over the time up to the last completion.

Correctness: the served tokens of each request, and with beams the score
of each sentence's best beam, are taken from the predictor's decode call as
it returns them (a wrapper around ``sampling.generate`` /
``beam_search``). After the window, with the program freed, the float32
reference (``reference/<model>.py``) scores a sample of the served
sentences teacher-forced from their windows (``judge``):

- ``token_gap``: the widest gap by which a served token's reference logit
  lies below the reference's k-th best of its position (k = 1 for greedy,
  the beam width for beams, since a surviving beam's token is among its
  parent's best W, and ``top_k`` for top-k sampling);
- ``score_gap`` (beams): the widest gap between the score the program
  returned for a sentence (its summed log-probability over its length) and
  the reference's score of the same tokens.

The control (``control``) is the reference serving the same windows itself,
one step below the served precision, judged by the same ``judge``.
"""

from __future__ import annotations

import statistics
import time

import numpy as np

from portbench import device as device_lib
from portbench import profile, programs, weights
from portbench.reference import lowp

TRACE_CALLS = 5
GROUP = 4            # windows the reference takes at a time


def rank_k(traffic: dict) -> int:
    """How far down the reference's ranking a served token may lie."""
    if traffic.get("beam_width", 0) > 1:
        return traffic["beam_width"]
    return traffic.get("top_k") or 1


def served_tokens(row: np.ndarray, eot: int) -> np.ndarray:
    """A sentence's served tokens, through its first end-of-text (after it
    a beam only pads and a sentence is cut)."""
    stops = np.nonzero(row == eot)[0]
    return row[: stops[0] + 1] if len(stops) else row


def token_gap(logits, tokens, k: int) -> float:
    """The widest gap by which a served token's logit lies below the k-th
    best logit of its position: logits [B, n, V] f32, tokens [B, n] with -1
    past each sentence's end."""
    import torch
    kth = torch.topk(logits, k, dim=-1).values[..., -1]
    valid = tokens >= 0
    got = torch.gather(logits, -1, tokens.clamp(min=0)[..., None])[..., 0]
    return float(torch.where(valid, (kth - got).clamp(min=0), 0.0).max())


def score_gap(logits, tokens, scores) -> float:
    """The widest gap between a sentence's served score [B] and the mean
    log-probability of its tokens [B, n] (-1 past its end) under
    ``logits``."""
    import torch
    valid = tokens >= 0
    logp = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                        tokens.clamp(min=0)[..., None])[..., 0]
    mean = torch.where(valid, logp, 0.0).sum(-1) / valid.sum(-1)
    return float((scores.to(mean) - mean).abs().max())


class Capture:
    """The served tokens (and scores) of each decode call: wraps
    ``sampling.generate`` and ``sampling.beam_search`` (which the predictor
    looks up at each call) and the model's ``encode`` in a
    ``portbench.encode`` span, from outside the program; ``close`` restores
    them."""

    def __init__(self, model):
        from torch.profiler import record_function
        from frankenstein_tpu_torch.decode import sampling
        self.sampling = sampling
        self.saved = {n: getattr(sampling, n)
                      for n in ("generate", "beam_search")}
        self.tokens, self.scores = [], []
        for name, fn in self.saved.items():
            setattr(sampling, name, self._wrap(fn))
        encode = model.encode

        def spanned(x, date_info=None):
            with record_function("portbench.encode"):
                return encode(x, date_info)
        model.encode = spanned

    def _wrap(self, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            toks, scores = out if isinstance(out, tuple) else (out, None)
            self.tokens.append(toks)
            self.scores.append(scores)
            return out
        return wrapped

    def served(self, n: int):
        """The first ``n`` calls' (tokens, scores) on the host."""
        host = lambda t: None if t is None else t.float().cpu().numpy()
        return ([t.cpu().numpy() for t in self.tokens[:n]],
                [host(s) for s in self.scores[:n]])

    def clear(self):
        self.tokens.clear()
        self.scores.clear()

    def close(self):
        for name, fn in self.saved.items():
            setattr(self.sampling, name, fn)


def build(spec, seed: int, device: str):
    prog, _ = programs.lookup(spec.config)
    return prog.build_serving(spec, seed, device)


def make_pool(spec, seed: int, device: str) -> list:
    prog, _ = programs.lookup(spec.config)
    return prog.serving_pool(spec, seed, device)


def run(spec, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    import torch
    tr = spec.traffic
    dev = torch.device(device)
    model, predict, shapes = build(spec, seed, device)
    pool = make_pool(spec, seed, device)
    order = np.random.default_rng(seed).permutation(len(pool))
    cap = Capture(model)
    try:
        for i in range(2):                      # warm-up: the cell's shape
            predict(pool[order[i % len(pool)]])
        device_lib.sync(dev)
        cap.clear()
        device_lib.reset_peak(dev)
        setup_s = time.perf_counter() - t_start
        lat, slots, sentences = [], [], 0
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            slot = int(order[len(lat) % len(pool)])
            t_call = time.perf_counter()
            out = predict(pool[slot])
            device_lib.sync(dev)
            t_end = time.perf_counter()
            lat.append(t_end - t_call)
            if len(out) != tr["batch"]:
                raise RuntimeError(f"predict returned {len(out)} strings")
            slots.append(slot)
            sentences += len(out)
        window_s = t_end - t0
        peak = device_lib.peak_bytes(dev)
        served, scores = cap.served(len(lat))
        outcome = {
            "end_to_end": {
                "setup_s": setup_s,
                tr.get("throughput_metric", "sentences_per_s"):
                    sentences / window_s,
                "request_ms_p95": 1e3 * _p95(lat),
                "peak_gib": peak / 2 ** 30},
            "memory_peak_bytes": peak, "attempted": len(lat), "failed": 0}
        context = {"kind": "serve", "config": spec.config, "traffic": tr,
                   "window_s": window_s, "requests": len(lat),
                   "sentences": sentences}
        if trace:
            tr_slots = [int(order[(len(lat) + i) % len(pool)])
                        for i in range(TRACE_CALLS)]
            got = profile.capture(lambda i: predict(pool[tr_slots[i]]),
                                  TRACE_CALLS)
            context["trace"] = got
            outcome.update(busy_s=got.busy_s, trace_window_s=got.window_s,
                           breakdown=got.breakdown())
        outcome["context"] = context
    finally:
        cap.close()
    del predict, model, cap
    device_lib.free(dev)
    t_ref = time.perf_counter()
    outcome["checks"] = check(spec, seed, device, shapes, pool, slots,
                              served, scores)
    outcome["reference_s"] = time.perf_counter() - t_ref
    return outcome


def sample(spec, seed: int, served: list) -> list:
    """(request, row) pairs drawn from the seed among the window's
    requests, the sentence with the most served tokens first."""
    _, ref = programs.lookup(spec.config)
    n_check = spec.traffic["check_sentences"]
    b = spec.traffic["batch"]
    pairs = [(r, i) for r in range(len(served)) for i in range(b)]
    lengths = [len(served_tokens(served[r][i], ref.EOT)) for r, i in pairs]
    longest = int(np.argmax(lengths))
    rng = np.random.default_rng(seed + 1)
    rest = [p for j, p in enumerate(pairs) if j != longest]
    pick = rng.choice(len(rest), size=min(n_check - 1, len(rest)),
                      replace=False)
    return [pairs[longest]] + [rest[int(j)] for j in sorted(pick)]


def padded(rows, eot: int, device):
    """Token rows cut after their first end-of-text, as [S, n] with -1 past
    each one's end, on the device."""
    import torch
    rows = [served_tokens(np.asarray(r), eot) for r in rows]
    toks = torch.full((len(rows), max(len(r) for r in rows)), -1,
                      dtype=torch.long)
    for j, r in enumerate(rows):
        toks[j, :len(r)] = torch.as_tensor(r)
    return toks.to(device)


def reference_inputs(spec, pool, slots, served, scores, chosen, device):
    """The sampled windows [S, T, C], their served tokens [S, n] (-1 past
    a sentence's end) and, with beams, their served scores [S], on the
    device."""
    import torch
    _, ref = programs.lookup(spec.config)
    toks = padded([served[r][i] for r, i in chosen], ref.EOT, device)
    x = torch.stack([pool[slots[r]][i] for r, i in chosen]).to(device)
    score = None
    if scores and scores[0] is not None:
        score = torch.tensor([float(scores[r][i]) for r, i in chosen],
                             device=device)
    return x, toks, score


def reference_params(spec, seed: int, shapes, device) -> dict:
    """The benchmark's weights as served, in float32 for the reference."""
    import torch
    _, ref = programs.lookup(spec.config)
    mc = spec.config["model_config"]
    return {k: v.float() for k, v in weights.make(
        shapes, ref.init_rule, seed, device, torch.bfloat16,
        ref.n_layer(mc)).items()}


def judge(spec, params: dict, x, toks, scores) -> dict:
    """{number: (reading, limit)} of served tokens [S, n] (and scores [S])
    for windows [S, T, C], against the float32 reference, TF32 off."""
    import torch
    _, ref = programs.lookup(spec.config)
    mc, limits = spec.config["model_config"], spec.traffic["limits"]
    with device_lib.exact_f32():
        logits = torch.cat([
            ref.served_logits(x[lo:lo + GROUP],
                              toks[lo:lo + GROUP].clamp(min=0), params, mc)
            for lo in range(0, x.shape[0], GROUP)])
    out = {"token_gap": (token_gap(logits, toks, rank_k(spec.traffic)),
                         limits["token_gap"])}
    if scores is not None:
        out["score_gap"] = (score_gap(logits, toks, scores),
                            limits["score_gap"])
    return out


def check(spec, seed: int, device: str, shapes, pool, slots, served,
          scores) -> dict:
    """``judge`` over a sample of the window's sentences."""
    chosen = sample(spec, seed, served)
    x, toks, score = reference_inputs(spec, pool, slots, served, scores,
                                      chosen, device)
    return judge(spec, reference_params(spec, seed, shapes, device), x,
                 toks, score)


def control_numerics(traffic: dict) -> lowp.LowPrecision:
    """One step below the served precision: fp8 for bf16, int4 for the
    w8a16 decode weights and, with ``int8_kv``, for the cache."""
    int8_w = traffic.get("int8_weights", False)
    return lowp.LowPrecision(
        int8_weight=lambda n: int8_w and n.startswith(
            "llm_model.transformer.h."),
        int8_kv=traffic.get("int8_kv", False))


def control(spec, seed: int, params: dict, x):
    """The control in the program's place: the reference at
    ``control_numerics`` serves windows [S, T, C] as the traffic asks
    (sampling from a generator seeded with ``seed``). Returns (tokens [S,
    n] with -1 past each end, scores [S] or None)."""
    import torch
    _, ref = programs.lookup(spec.config)
    num = control_numerics(spec.traffic)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    toks, scores = [], []
    with device_lib.exact_f32():
        for lo in range(0, x.shape[0], GROUP):
            t, s = ref.decode(x[lo:lo + GROUP], params,
                              spec.config["model_config"], spec.traffic,
                              num, gen)
            toks += list(t.cpu().numpy())
            scores.append(s)
    score = None if scores[0] is None else torch.cat(scores)
    return padded(toks, ref.EOT, x.device), score


def _p95(values: list) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[-1]
