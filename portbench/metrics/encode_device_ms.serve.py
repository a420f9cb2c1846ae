"""Device time a request of the kernels launched inside the encode
(``portbench.encode``, a span around the model's ``encode``), in ms.

Reported in the offline top-k cell."""

from portbench.metrics._common import encode_device_ms as read  # noqa: F401
