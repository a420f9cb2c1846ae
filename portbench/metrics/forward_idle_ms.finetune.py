"""Device idle time an optimizer step inside the trainer's
``train.forward`` spans (``train/trainer.py``, one a microbatch): the
spans less the time any device operation ran, in ms.

Reported in Franky's training cell."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.idle_ms(ctx, "train.forward")
