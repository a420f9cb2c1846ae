"""K7 dense's share of its roofline in the MAE's decoder: the op bound of
its forward, dq and dk/dv passes (``counts.k7_dense_bounds``, every pair)
at the microbatch's shape over their device time, in %."""

from portbench import counts

FAMILIES = ("K7 fwd", "K7 bwd dq", "K7 bwd dk/dv")


def read(ctx):
    if ctx.get("kind") != "train" or "trace" not in ctx:
        return None
    trace, cfg, tr = ctx["trace"], ctx["config"], ctx["traffic"]
    secs = sum(trace.family_s(f)[0] for f in FAMILIES)
    if secs == 0 or cfg["model"] != "mae":
        return None
    mc = cfg["model_config"]
    n_tok = (mc["window_size"] // mc["patch_size"]) * mc["n_electrodes"]
    fwd, bwd = counts.k7_dense_bounds(tr["batch"] // tr["grad_accum"],
                                      n_tok, mc["n_heads"], mc["head_dim"])
    launches = trace.calls * tr["grad_accum"] * mc["n_dec_layers"]
    return 100.0 * launches * (fwd + bwd) / secs
