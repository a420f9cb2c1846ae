"""Device time a request of the operations launched inside LFM2's
``lfm2.conv`` spans (``models/lfm2.py``: in_proj, the short convolution
over the conv state, out_proj), in ms.

Reported in the LFM2 beam cell."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "lfm2.conv")
