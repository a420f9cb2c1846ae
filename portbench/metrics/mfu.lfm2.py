"""The whole request's share of the card's bf16 peak: the model FLOPs of
the window's requests (``counts_lfm2.request_flops``: the encode with its
visible pairs, the prefill, every decoded row with its chosen experts)
over the window's seconds times 989e12, in %.

Reported in the LFM2 beam cell."""

from portbench import counts, counts_lfm2


def read(ctx):
    if ctx.get("kind") != "serve" or "lm" not in ctx["config"].get(
            "model_config", {}):
        return None
    tr = ctx["traffic"]
    rows = tr["batch"] * max(tr.get("beam_width", 0), 1)
    flops = ctx["requests"] * counts_lfm2.request_flops(
        ctx["config"]["model_config"], tr["batch"], rows,
        tr["max_new_tokens"])
    return 100.0 * flops / (ctx["window_s"] * counts.PEAK_BF16_FLOPS)
