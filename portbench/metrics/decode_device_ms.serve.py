"""Device time a request of everything the predictor launches after the
encode (prefill, the decode steps, beam reorders, the head), in ms.

Reported in the offline top-k cell."""

from portbench.metrics._common import decode_device_ms as read  # noqa: F401
