"""The whole request's share of the card's bf16 peak: the model FLOPs of
the window's completed sentences (``counts.franky_request_flops``: the
encode with its visible pairs, the prefill, every decoded row) over the
window's seconds times 989e12, in %.

Reported in the offline top-k cell."""

from portbench.metrics._common import mfu as read  # noqa: F401
