"""Device idle time a request inside the predictor's ``predict.decode``
span (``decode/pipeline.py``: prefill, the decode loop, beams' ranking):
the span less the time any device operation ran, in ms.

Reported in the offline top-k cell."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.idle_ms(ctx, "predict.decode")
