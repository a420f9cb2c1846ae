"""Host time an optimizer step that the trainer waits for its batch in
the loader's ``loader.wait`` span (``data/loader.py:prefetch``, the
consumer's ``q.get()``), in ms.

Reported in Franky's training cell."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.host_ms(ctx, "loader.wait")
