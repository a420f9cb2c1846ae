"""Plain PyTorch ops; ``ops/cuda`` holds the hand-written kernels' wrappers."""
