"""The share of the traced slice's span (its requests, or optimizer
steps) in which no device operation ran, in %; the profiler's own host
cost is inside that span.

Reported in the beam-search submission cell."""

from portbench.metrics._common import device_idle_pct as read  # noqa: F401
