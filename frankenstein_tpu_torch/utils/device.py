"""The device a command-line entry point runs on."""

from __future__ import annotations

import torch


def cli_device(name: str) -> torch.device:
    """``cuda`` (the default of every CLI) or ``cpu``. ``cuda`` without a
    usable GPU exits with a message that names ``--device cpu``: the CLIs
    never fall back to the CPU on their own."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no usable CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    return torch.device(name)
