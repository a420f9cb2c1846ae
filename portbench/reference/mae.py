"""Plain float32 MAE pretrainer over the BrainFormer encoder: the encoder
sees the kept 25% of the tokens with the slab-causal mask over their
original positions, the decoder all tokens (mask token elsewhere, learned
positions, dense attention, no RoPE), and the loss is the squared error of
the masked patches.

``params`` maps the model's parameter names (``encoder.*``,
``decoder.h.*``, ``mask_token``, ``decoder_pos_emb.weight``,
``to_signals.*``) to float32 tensors.
"""

from __future__ import annotations

import torch

from portbench.reference.blocks import (FP32, Numerics, block, layer_norm,
                                        linear, rope_table, slab_allowed,
                                        to_patches)


def masks(generator: torch.Generator, batch: int, n_tokens: int,
          ratio: float, device):
    """(masked, kept) sorted index sets [B, int(ratio * N)] and the rest:
    the argsort of uniforms drawn from ``generator``, the MAE's own rule
    for its mask."""
    n_masked = int(ratio * n_tokens)
    noise = torch.rand(batch, n_tokens, generator=generator, device=device)
    perm = torch.argsort(noise, dim=-1)
    return (torch.sort(perm[:, :n_masked], dim=-1).values,
            torch.sort(perm[:, n_masked:], dim=-1).values)


def _take(x, idx):
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def loss_sum(x, masked, kept, params: dict, cfg: dict,
             num: Numerics = FP32, chunk: int = 1024):
    """(summed squared error, count) of the masked patches of rows [B]."""
    p = cfg["patch_size"]
    patches = to_patches(x, p)
    b, n, _ = patches.shape
    tok = linear(_take(patches, kept), params, "encoder.transformer.emb", num)
    space = params["encoder.space_embedding"][0]
    space = space.repeat(n // space.shape[0], 1)
    tok = tok + space[kept]
    cos, sin = rope_table(cfg["head_dim"], kept, cfg.get("rope_theta",
                                                         10000.0))
    tpt = cfg["n_electrodes"]
    allowed_fn = lambda lo, hi: slab_allowed(kept[:, lo:hi], kept, tpt)
    for i in range(cfg["n_layers"]):
        tok = block(tok, params, f"encoder.transformer.h.{i}",
                    cfg["n_heads"], (cos, sin), allowed_fn, num, chunk)
    tok = layer_norm(tok, params, "encoder.transformer.ln_f")
    dec = params["mask_token"].expand(b, n, -1)
    dec = torch.scatter(dec, 1, kept[..., None].expand(-1, -1,
                                                       dec.shape[-1]), tok)
    dec = dec + params["decoder_pos_emb.weight"][:n][None]
    dense = lambda lo, hi: None
    for i in range(cfg["n_dec_layers"]):
        dec = block(dec, params, f"decoder.h.{i}", cfg["n_heads"], None,
                    dense, num, chunk)
    pred = linear(_take(dec, masked), params, "to_signals", num)
    err = (pred - _take(patches, masked)) ** 2
    return err.sum(), err.numel()


def micro_losses(batch, accum: int, rows: int, seed: int, step: int,
                 params: dict, cfg: dict, num: Numerics = FP32):
    """Yield (summed loss of a block of ``rows`` rows, its microbatch's
    count of masked values) over the ``accum`` microbatches of one step's
    batch (windows,) on the device. Each microbatch's masks are drawn in
    turn from a generator seeded with ``seed * 1_000_003 + step``, the
    trainer's seed for the step's draws."""
    x = batch[0]
    micro = x.shape[0] // accum
    gen = torch.Generator(device=x.device).manual_seed(
        seed * 1_000_003 + step)
    n_tok = (cfg["window_size"] // cfg["patch_size"]) * cfg["n_electrodes"]
    for lo in range(0, x.shape[0], micro):
        masked, kept = masks(gen, micro, n_tok, cfg["masking_ratio"],
                             x.device)
        count = masked.numel() * cfg["patch_size"]
        for r in range(0, micro, rows):
            yield loss_sum(x[lo + r:lo + r + rows], masked[r:r + rows],
                           kept[r:r + rows], params, cfg, num)[0], count


def n_layer(cfg: dict) -> int:
    """No weight of the MAE is scaled by depth."""
    return 0


def init_rule(name: str, shape, n_layer: int = 0):
    """(mean, std) of the benchmark's weights for parameter ``name``: the
    model's initialisers' scales (lecun-normal kernels, the electrode
    embedding and the mask token at 1, the decoder's positions at
    1/sqrt(width)), with norms near 1 and biases near 0 but not equal to
    them, so that the comparison covers every parameter."""
    if name.endswith("bias"):
        return 0.0, 0.02
    if ".ln_" in name or ".ln_f" in name:
        return 1.0, 0.05
    if name in ("encoder.space_embedding", "mask_token"):
        return 0.0, 1.0
    return 0.0, 1.0 / (shape[1] ** 0.5)
