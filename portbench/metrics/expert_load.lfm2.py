"""The routing's skew: for each routed layer the busiest expert's rows
over the mean expert's, averaged over the layers, from the program's
device-side count of the rows routed to each expert over the run
(``models/moe.py:rows_per_expert``, read after the run).

Reported in the LFM2 beam cell."""


def read(ctx):
    try:
        from frankenstein_tpu_torch.models import moe
    except ImportError:
        return None
    count = getattr(moe, "rows_per_expert", None)
    if ctx.get("kind") != "serve" or count is None:
        return None
    load = count().double()
    if load.numel() == 0 or float(load.sum()) == 0:
        return None
    return float((load.max(1).values / load.mean(1)).mean())
