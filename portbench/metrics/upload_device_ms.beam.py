"""Device time a request of the input's host-to-device copy: the
operations launched inside the predictor's ``predict.upload`` span
(``decode/pipeline.py``), in ms.

Reported in the beam-search submission cell."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "predict.upload")
