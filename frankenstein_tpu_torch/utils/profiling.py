"""FLOP and byte counts, MFU and profiler capture
(``frankenstein_tpu/utils/profiling.py``).

The analytic counts are the JAX package's, copied as they are (the PaLM
Appendix B convention the reference uses: forward matmul FLOPs, x3 for a
training step). The peaks are the card's: ``detect_peak_flops()`` and
``detect_hbm_bw()`` read ``torch.cuda.get_device_name()`` and know the
NVIDIA H100 80GB HBM3 (SXM) from NVIDIA's data sheet, 989e12 dense bf16
tensor-core FLOP/s and 3.35e12 B/s of HBM. An unknown card, or no card,
gives None: the port states no figure it was not given.
``chip_smoke.py`` takes its roofline constants from here.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Optional

# NVIDIA's data sheet for the H100 SXM5 80 GB (dense, no sparsity)
H100_SXM = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = {H100_SXM: 989e12}          # bf16 tensor cores
PEAK_INT8_OPS = {H100_SXM: 1979e12}      # int8 tensor cores
HBM_BW = {H100_SXM: 3.35e12}             # bytes a second


def _device_name() -> Optional[str]:
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


def detect_peak_flops(name: Optional[str] = None) -> Optional[float]:
    """Dense bf16 FLOP/s of the card named ``name`` (the current CUDA
    device by default); None for an unknown card or without one."""
    return PEAK_FLOPS.get(name or _device_name())


def detect_hbm_bw(name: Optional[str] = None) -> Optional[float]:
    """HBM bytes a second of the card named ``name`` (the current CUDA
    device by default); None for an unknown card or without one."""
    return HBM_BW.get(name or _device_name())


def transformer_flops_per_token(n_params: int, n_layer: int, n_head: int,
                                head_dim: int, seq_len: int) -> float:
    """PaLM Appendix B: 6N + 12*L*H*Q*T."""
    return 6 * n_params + 12 * n_layer * n_head * head_dim * seq_len


def block_stack_fwd_flops(seq: int, dim: int, hidden: int, n_heads: int,
                          head_dim: int, n_layers: int, *,
                          kv_seq: Optional[int] = None,
                          n_mlp_mats: int = 3) -> float:
    """Forward matmul FLOPs of a stack of attention blocks: per token and
    layer the qkv and output projections, the MLP's matmuls (3 SwiGLU, 2
    GELU) and the two attention products over ``kv_seq`` keys."""
    kv = kv_seq if kv_seq is not None else seq
    inner = n_heads * head_dim
    qkv = 2 * dim * 3 * inner
    proj = 2 * inner * dim
    mlp = 2 * dim * hidden * n_mlp_mats
    attn = 4 * kv * inner
    return float(n_layers) * seq * (qkv + proj + mlp + attn)


def franky_encode_flops_per_sample(cfg) -> float:
    """Forward FLOPs of Franky's BrainEncoder (the MAE encoder, the
    Perceiver's cross and self blocks, the output projection): the encode
    of a served request, everything before the LM."""
    e, p = cfg.brain.encoder, cfg.brain
    n_tok = e.block_size
    enc = (2 * e.patch_size * e.dim * n_tok
           + block_stack_fwd_flops(n_tok, e.dim, e.hidden_dim, e.n_heads,
                                   e.head_dim, e.n_layers))
    nq = p.n_output_tokens
    inner = p.n_heads * p.head_dim
    cross = p.n_layers * (2 * p.dim * inner * nq            # q proj
                          + 2 * p.dim * 2 * inner * n_tok   # kv proj
                          + 4 * n_tok * inner * nq          # attention dots
                          + 2 * inner * p.dim * nq)
    perceiver = cross + block_stack_fwd_flops(nq, p.dim, p.hidden_dim,
                                              p.n_heads, p.head_dim,
                                              p.n_layers)
    proj_out = 2 * p.dim * p.output_dim * nq
    return enc + perceiver + proj_out


def franky_fwd_flops_per_sample(cfg) -> float:
    """Forward FLOPs of one Franky sample (encoder, Perceiver, GPT-2)."""
    g = cfg.gpt
    t_full = cfg.brain.n_output_tokens + cfg.max_tokens
    gpt = (block_stack_fwd_flops(t_full, g.n_embd, 4 * g.n_embd, g.n_head,
                                 g.head_dim, g.n_layer, n_mlp_mats=2)
           + 2 * g.n_embd * g.vocab_size * cfg.max_tokens)  # tied head
    return franky_encode_flops_per_sample(cfg) + gpt


def franky_llama_fwd_flops_per_sample(cfg) -> float:
    """Forward FLOPs of one FrankyLlama sample (encoder, Perceiver, and the
    LLaMA with its GQA-sized k/v projections)."""
    lm = cfg.lm
    t_full = cfg.brain.n_output_tokens + cfg.max_tokens
    hd = lm.head_dim
    # the stack prices k/v at n_heads * head_dim; LLaMA's use n_kv_heads
    stack = block_stack_fwd_flops(t_full, lm.dim, lm.hidden_dim, lm.n_heads,
                                  hd, lm.n_layers, n_mlp_mats=3)
    gqa_save = (lm.n_layers * t_full
                * 2 * lm.dim * 2 * (lm.n_heads - lm.n_kv_heads) * hd)
    head = 2 * lm.dim * lm.vocab_size * cfg.max_tokens
    return franky_encode_flops_per_sample(cfg) + stack - gqa_save + head


def gpt_decode_hbm_bytes(gcfg, batch: int, cache_len: int, n_tokens: int,
                         *, weight_bytes: int = 2, cache_bytes: int = 2,
                         lm_head_bytes: int = None,
                         lm_head_every_step: bool = True) -> float:
    """The least device-memory traffic (bytes) of ``n_tokens`` KV-cached
    GPT decode steps at batch ``batch``: the byte side of a decode step's
    roofline.

    A step reads every block weight once (qkv E*3E, projection E*E, MLP
    2*E*4E: 12E^2 a layer), the tied head (E*vocab) once, the whole
    allocated K/V cache (2 * L * B * cache_len * E), and writes one row a
    layer. Activations do not count: kernel K2 (``csrc/fused_decode.cu``)
    runs all layers of a step in one launch and keeps them in shared memory
    and registers. ``weight_bytes`` sizes the block weights and
    ``lm_head_bytes`` the head (``weight_bytes`` by default); they differ
    under w8a16, which quantizes only the blocks' matmuls."""
    e = gcfg.n_embd
    if lm_head_bytes is None:
        lm_head_bytes = weight_bytes
    block_w = gcfg.n_layer * 12 * e * e * weight_bytes
    lm_head = (e * gcfg.vocab_size * lm_head_bytes
               if lm_head_every_step else 0.0)
    cache_read = 2 * gcfg.n_layer * batch * cache_len * e * cache_bytes
    cache_write = 2 * gcfg.n_layer * batch * e * cache_bytes
    return float(n_tokens) * (block_w + lm_head + cache_read + cache_write)


def mae_fwd_flops_per_sample(cfg) -> float:
    """MAE pretraining forward: the encoder on the kept tokens, the dense
    decoder on all of them."""
    n_tok = cfg.block_size
    kept = n_tok - int(cfg.masking_ratio * n_tok)
    enc = (2 * cfg.patch_size * cfg.dim * kept
           + block_stack_fwd_flops(kept, cfg.dim, cfg.hidden_dim, cfg.n_heads,
                                   cfg.head_dim, cfg.n_layers))
    dec = block_stack_fwd_flops(n_tok, cfg.decoder_dim, cfg.hidden_dim,
                                cfg.n_heads, cfg.head_dim, cfg.n_dec_layers)
    head = 2 * cfg.decoder_dim * cfg.patch_size * n_tok
    return enc + dec + head


def vqvae_fwd_flops_per_sample(cfg, t: int = 768) -> float:
    """The causal-conv codec: 2 * Cin * Cout * k * T_out a conv, and the
    codebook lookup."""

    def conv(cin, cout, k, tout):
        return 2.0 * cin * cout * k * tout

    def res_units(ch, tout):
        # 3 ResidualUnits: a k3 conv and a 1x1 conv each
        return 3 * (conv(ch, ch, 3, tout) + conv(ch, ch, 1, tout))

    total, cur_t = 0.0, t
    total += conv(cfg.n_electrodes, cfg.C, 5, cur_t)
    for s in cfg.strides:
        total += res_units(cfg.C, cur_t)
        cur_t //= s
        total += conv(cfg.C, cfg.C, 2 * s, cur_t)
    total += conv(cfg.C, cfg.D, 3, cur_t)
    total += 2 * cfg.D * cfg.codebook_size * cur_t      # VQ lookup
    total += conv(cfg.D, cfg.C, 3, cur_t)
    for s in reversed(cfg.strides):
        total += conv(cfg.C, cfg.C, 2 * s, cur_t)
        cur_t *= s
        total += res_units(cfg.C, cur_t)
    total += conv(cfg.C, cfg.n_electrodes, 5, cur_t)
    return total


def estimate_mfu(flops_per_iter: float, iter_time_s: float,
                 peak_flops: Optional[float] = None) -> Optional[float]:
    """FLOPs a second over the peak (the card's by default); None where no
    peak is known."""
    peak = peak_flops if peak_flops is not None else detect_peak_flops()
    if peak is None:
        return None
    return flops_per_iter / max(iter_time_s, 1e-12) / peak


def count_parameters(model_or_state) -> int:
    """Total element count of a module's parameters, or of every tensor of
    a state dict."""
    tensors = (model_or_state.values() if isinstance(model_or_state, dict)
               else model_or_state.parameters())
    return int(sum(t.numel() for t in tensors))


@contextlib.contextmanager
def trace(logdir: str = "trace"):
    """torch.profiler around a block (CPU and, where there is one, CUDA
    activity); on exit the Chrome trace is ``<logdir>/trace.json``. Yields
    the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
