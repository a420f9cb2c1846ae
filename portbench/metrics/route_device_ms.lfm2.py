"""Device time a request of the operations launched inside the routed
experts' ``moe.route`` (f32 router, top-k, the sort by expert, the
offsets) and ``moe.combine`` (unsort, each row's weighted sum) spans, in
ms.

Reported in the LFM2 beam cell."""

from portbench.metrics import _spans


def read(ctx):
    parts = [_spans.device_ms(ctx, name)
             for name in ("moe.route", "moe.combine")]
    if all(p is None for p in parts):
        return None
    return sum(p for p in parts if p is not None)
