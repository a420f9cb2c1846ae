"""Wrappers of the CUDA kernels in ``frankenstein_tpu_torch/csrc``, each with
its plain PyTorch twin and a launch counter."""
