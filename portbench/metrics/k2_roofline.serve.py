"""K2's share of its roofline over a request's decode steps: the byte
bound of each step at its cache length (``counts.k2_bound``: live rows,
the w8a16 weights and scales, the bf16 or int8 cache as the cell runs it)
over its device time, in %.

Reported in the offline top-k cell."""

from portbench.metrics._common import k2_roofline as read  # noqa: F401
