"""The program's MAE pretrainer as the benchmark drives it: the trained
model and its inputs, drawn from the seed. Its plain twin is
``reference/mae.py``."""

from __future__ import annotations


def build_training(model_config: dict, dev, dtype):
    from frankenstein_tpu_torch.config import MAEConfig
    from frankenstein_tpu_torch.models.brainformer import MAE
    return MAE(MAEConfig.from_dict(model_config), device=dev, dtype=dtype)


def training_pool(spec, seed: int, device: str) -> list:
    """``pool_batches`` host batches (windows,) of ``batch`` windows [T, C]
    f32 drawn from the seed on the device, every row its own."""
    import torch
    mc, tr = spec.config["model_config"], spec.traffic
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(tr["pool_batches"], tr["batch"], mc["window_size"],
                    mc["n_electrodes"], generator=gen,
                    device=device).cpu().numpy()
    return [(x[i],) for i in range(len(x))]
