"""The per-layer readers: each metric file names one of these, so a
quantity measured alike in cells whose end-to-end metrics differ is read by
one function (``.serve`` the top-k cell's, ``.beam`` the beam cell's,
``.train`` the MAE's, ``.finetune`` Franky's training)."""

from __future__ import annotations

from portbench import counts
from portbench.profile import CALL

ENCODE = "portbench.encode"


def served(ctx: dict) -> dict | None:
    """The serving cell's shapes, or None outside one or without a
    trace."""
    if ctx.get("kind") != "serve" or "trace" not in ctx:
        return None
    mc, tr = ctx["config"]["model_config"], ctx["traffic"]
    enc = mc["brain"]["encoder"]
    w = tr.get("beam_width", 0)
    return {"batch": tr["batch"], "rows": tr["batch"] * max(w, 1),
            "tokens": tr["max_new_tokens"], "enc": enc, "gpt": mc["gpt"],
            "prefix": mc["brain"]["n_output_tokens"],
            "n_tok": (enc["window_size"] // enc["patch_size"])
            * enc["n_electrodes"]}


def decode_ops(trace) -> list:
    """The operations each traced request launched after its encode."""
    encodes = sorted(trace.spans.get(ENCODE, []))
    out = []
    for lo, hi in trace.spans.get(CALL, []):
        ends = [e for s, e in encodes if lo <= s <= hi]
        if not ends:
            continue
        after = max(ends)
        out += [o for o in trace.ops if after < o.launch <= hi]
    return out


def encode_device_ms(ctx):
    """Device time a request of the kernels launched inside the encode
    (``portbench.encode``, a span around the model's ``encode``), in ms."""
    if served(ctx) is None:
        return None
    trace = ctx["trace"]
    ops = trace.in_span(ENCODE)
    if not ops:
        return None
    return 1e3 * sum(o.dur for o in ops) / trace.calls


def decode_device_ms(ctx):
    """Device time a request of everything the predictor launches after the
    encode (prefill, the decode steps, beam reorders, the head), in ms."""
    if served(ctx) is None:
        return None
    trace = ctx["trace"]
    ops = decode_ops(trace)
    if not ops:
        return None
    return 1e3 * sum(o.dur for o in ops) / trace.calls


def k1_roofline(ctx):
    """K1's share of its roofline in the encode (K10's, when ``qk_int8``
    routes the encode there): the op bound of its launch shape
    (``counts.k1_bound``, visible slab pairs) over its device time, in %."""
    cell = served(ctx)
    if cell is None:
        return None
    trace = ctx["trace"]
    int8 = trace.family_s("K10")[1] > 0
    secs, n = trace.family_s("K10" if int8 else "K1")
    if n == 0:
        return None
    enc = cell["enc"]
    launches = trace.calls * enc["n_layers"]
    bound = counts.k1_bound(cell["batch"], cell["n_tok"], enc["n_heads"],
                            enc["head_dim"], enc["n_electrodes"], int8)
    return 100.0 * launches * bound / secs


def k2_roofline(ctx):
    """K2's share of its roofline over a request's decode steps: the byte
    bound of each step at its cache length (``counts.k2_bound``: live rows,
    the w8a16 weights and scales, the bf16 or int8 cache as the cell runs it)
    over its device time, in %."""
    cell = served(ctx)
    if cell is None:
        return None
    trace, tr = ctx["trace"], ctx["traffic"]
    secs, n = trace.family_s("K2")
    if n == 0:
        return None
    gpt, t0 = cell["gpt"], cell["prefix"] + 1
    bound = sum(counts.k2_bound(
        cell["rows"], gpt["n_layer"], gpt["n_embd"],
        t0 + j % cell["tokens"], int8_weights=tr.get("int8_weights", False),
        int8_kv=tr.get("int8_kv", False)) for j in range(n))
    return 100.0 * bound / secs


def mfu(ctx):
    """The whole request's share of the card's bf16 peak: the model FLOPs of
    the window's completed sentences (``counts.franky_request_flops``: the
    encode with its visible pairs, the prefill, every decoded row) over the
    window's seconds times 989e12, in %."""
    cell = served(ctx)
    if cell is None:
        return None
    flops = ctx["requests"] * counts.franky_request_flops(
        ctx["config"]["model_config"], cell["batch"], cell["rows"],
        cell["tokens"])
    return 100.0 * flops / (ctx["window_s"] * counts.PEAK_BF16_FLOPS)


def device_idle_pct(ctx):
    """The share of the traced slice's span (its requests, or optimizer
    steps) in which no device operation ran, in %; the profiler's own host
    cost is inside that span."""
    if "trace" not in ctx:
        return None
    trace = ctx["trace"]
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu_train(ctx):
    """The whole step's share of the card's bf16 peak: 3 x the forward FLOPs
    (visible attention pairs; ``counts.franky_train_fwd_flops`` or
    ``counts.mae_fwd_flops``) of every sample of the window's steps over
    the window's seconds times 989e12, in %."""
    if ctx.get("kind") != "train":
        return None
    cfg = ctx["config"]
    if cfg["model"] == "franky":
        fwd = counts.franky_train_fwd_flops(cfg["model_config"],
                                            ctx["traffic"]["max_tokens"])
    else:
        fwd = counts.mae_fwd_flops(cfg["model_config"])
    return 100.0 * 3 * fwd * ctx["samples"] / (
        ctx["window_s"] * counts.PEAK_BF16_FLOPS)
