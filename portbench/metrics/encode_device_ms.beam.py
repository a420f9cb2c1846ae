"""Device time a request of the kernels launched inside the encode
(``portbench.encode``, a span around the model's ``encode``), in ms.

Reported in the beam-search submission cell."""

from portbench.metrics._common import encode_device_ms as read  # noqa: F401
