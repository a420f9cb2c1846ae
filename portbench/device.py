"""Small device helpers the generators share."""

from __future__ import annotations

import gc


class exact_f32:
    """TF32 off for the reference's products, restored after."""

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        import torch
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev) -> None:
    """Collect what the program left and hand the cached blocks back."""
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev) -> int:
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
