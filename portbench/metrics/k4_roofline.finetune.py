"""K4's share of its roofline in Franky's encoder backward: the op bound
(``counts.k4_bound``, visible slab pairs) at the microbatch's shape over
its device time (pre-pass, dq and dk/dv passes), in %."""

from portbench import counts


def read(ctx):
    if ctx.get("kind") != "train" or "trace" not in ctx:
        return None
    trace, cfg, tr = ctx["trace"], ctx["config"], ctx["traffic"]
    secs, n = trace.family_s("K4")
    if n == 0 or cfg["model"] != "franky":
        return None
    enc = cfg["model_config"]["brain"]["encoder"]
    n_tok = (enc["window_size"] // enc["patch_size"]) * enc["n_electrodes"]
    bound = counts.k4_bound(tr["batch"] // tr["grad_accum"], n_tok,
                            enc["n_heads"], enc["head_dim"],
                            enc["n_electrodes"])
    launches = trace.calls * tr["grad_accum"] * enc["n_layers"]
    return 100.0 * launches * bound / secs
