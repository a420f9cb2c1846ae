"""The routed experts' share of their roofline over a request: the bound of
every call (``counts_lfm2.experts_bound``: the experts with a row read
once, expected from each layer's measured shares of the routed rows
(``models/moe.py:rows_per_expert``; even shares without it), each pair's
row in and out; the prefill's 160 x 33 tokens at the larger of bytes and
FLOPs) over the device time launched inside ``moe.experts``, in %. The
decode steps are counted from the traced ``decode.step`` spans.

Reported in the LFM2 beam cell."""

from portbench import counts_lfm2
from portbench.metrics import _spans


def _shares(n_layers: int):
    """Each routed layer's [E] shares of the rows, or Nones."""
    try:
        from frankenstein_tpu_torch.models import moe
        rows = moe.rows_per_expert().double()
    except (ImportError, AttributeError):
        return [None] * n_layers
    if rows.shape[0] != n_layers or float(rows.sum()) == 0:
        return [None] * n_layers
    return list(rows / rows.sum(1, keepdim=True))


def read(ctx):
    secs = _spans.device_ms(ctx, "moe.experts")
    trace = ctx.get("trace")
    if not secs or ctx.get("kind") != "serve" or trace is None:
        return None
    mc, tr = ctx["config"]["model_config"], ctx["traffic"]
    lm = mc["lm"]
    rows = tr["batch"] * max(tr.get("beam_width", 0), 1)
    steps = len(trace.spans.get("decode.step", [])) / trace.calls
    prefill = rows * (mc["brain"]["n_output_tokens"] + 1)
    bound = sum(counts_lfm2.experts_bound(lm, prefill, p)
                + steps * counts_lfm2.experts_bound(lm, rows, p)
                for p in _shares(counts_lfm2.routed_layers(lm)))
    return 100.0 * 1e3 * bound / secs
