"""Device time a request of the operations launched inside the routed
experts' ``moe.experts`` spans (``models/moe.py:RoutedExperts``: the rows'
gather, the two grouped products and the SwiGLU between them), in ms.

Reported in the LFM2 beam cell."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "moe.experts")
