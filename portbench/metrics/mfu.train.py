"""The whole step's share of the card's bf16 peak: 3 x the forward FLOPs
(visible attention pairs; ``counts.franky_train_fwd_flops`` or
``counts.mae_fwd_flops``) of every sample of the window's steps over
the window's seconds times 989e12, in %.

Reported in the MAE pretraining cell."""

from portbench.metrics._common import mfu_train as read  # noqa: F401
