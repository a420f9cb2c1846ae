"""FLOP counts, MFU, profiler capture and the port's trace spans
(``frankenstein_tpu/utils/profiling.py``).

The analytic counts follow the PaLM Appendix B convention the JAX package
uses (forward matmul FLOPs, x3 for a training step), with attention over
the (query, key) pairs its mask leaves visible, as the benchmark counts
them (``portbench/counts.py``): slab-causal in the encoder, causal in the
LM, the expected gathered pairs of the MAE's kept tokens. The JAX package
counts every pair. The peaks are the card's: ``detect_peak_flops()`` and
``detect_hbm_bw()`` read ``torch.cuda.get_device_name()`` and know the
NVIDIA H100 80GB HBM3 (SXM) from NVIDIA's data sheet, 989e12 dense bf16
tensor-core FLOP/s and 3.35e12 B/s of HBM. An unknown card, or no card,
gives None: the port states no figure it was not given.
``chip_smoke.py`` takes its roofline constants from here.

``span(name)`` marks a layer of the port (the predictor's phases, the
decode loop, the trainer's phases, the loader's wait) in a torch.profiler
trace, on the profiler's own clock; ``trace()`` records one. With no
profiler recording a span costs one check.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Optional

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

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


def _slab_pairs(t: int, p: int) -> int:
    """(query, key) pairs the slab-causal mask allows over ``t`` tokens in
    slabs of ``p``."""
    return sum(min(t, (i // p + 1) * p) for i in range(t))


def _causal_pairs(t: int) -> int:
    """(query, key) pairs a causal mask allows over ``t`` tokens."""
    return t * (t + 1) // 2


def _gathered_pairs(t: int, kept: int, p: int) -> float:
    """Expected visible pairs of the MAE's kept-token encoder, ``kept`` of
    ``t`` tokens drawn uniformly without replacement under the slab mask:
    each kept token sees itself, and each other visible pair survives with
    probability k(k-1) / (t(t-1))."""
    keep_both = kept * (kept - 1) / (t * (t - 1))
    return kept + (_slab_pairs(t, p) - t) * keep_both


def block_stack_fwd_flops(seq: int, dim: int, hidden: int, n_heads: int,
                          head_dim: int, n_layers: int, *,
                          kv_seq: Optional[int] = None,
                          n_mlp_mats: int = 3,
                          pairs: Optional[float] = None) -> float:
    """Forward matmul FLOPs of a stack of attention blocks: per token and
    layer the qkv and output projections and the MLP's matmuls (3 SwiGLU,
    2 GELU); per (query, key) pair of one head and layer the two attention
    products, over ``pairs`` (every pair of ``seq`` queries and ``kv_seq``
    keys by default)."""
    kv = kv_seq if kv_seq is not None else seq
    if pairs is None:
        pairs = seq * kv
    inner = n_heads * head_dim
    qkv = 2 * dim * 3 * inner
    proj = 2 * inner * dim
    mlp = 2 * dim * hidden * n_mlp_mats
    return float(n_layers) * (seq * (qkv + proj + mlp) + 4 * inner * pairs)


def franky_encode_flops_per_sample(cfg) -> float:
    """Forward FLOPs of Franky's BrainEncoder: the MAE encoder over its
    slab-causal pairs, the Perceiver's cross blocks (with their MLP) and
    self blocks, the output projection: the encode of a served request,
    everything before the LM."""
    e, p = cfg.brain.encoder, cfg.brain
    n_tok = e.block_size
    enc = (2 * e.patch_size * e.dim * n_tok
           + block_stack_fwd_flops(n_tok, e.dim, e.hidden_dim, e.n_heads,
                                   e.head_dim, e.n_layers,
                                   pairs=_slab_pairs(n_tok, e.n_electrodes)))
    nq = p.n_output_tokens
    inner = p.n_heads * p.head_dim
    cross = p.n_layers * (2 * p.dim * inner * nq            # q proj
                          + 2 * p.dim * 2 * inner * n_tok   # kv proj
                          + 4 * n_tok * inner * nq          # attention dots
                          + 2 * inner * p.dim * nq          # out proj
                          + 2 * p.dim * p.hidden_dim * 3 * nq)   # SwiGLU
    perceiver = cross + block_stack_fwd_flops(nq, p.dim, p.hidden_dim,
                                              p.n_heads, p.head_dim,
                                              p.n_layers)
    proj_out = 2 * p.dim * p.output_dim * nq
    return enc + perceiver + proj_out


def franky_fwd_flops_per_sample(cfg) -> float:
    """Forward FLOPs of one Franky sample (encoder, Perceiver, GPT-2 over
    its causal pairs, the tied head on the text positions)."""
    g = cfg.gpt
    t_full = cfg.brain.n_output_tokens + cfg.max_tokens
    gpt = (block_stack_fwd_flops(t_full, g.n_embd, 4 * g.n_embd, g.n_head,
                                 g.head_dim, g.n_layer, n_mlp_mats=2,
                                 pairs=_causal_pairs(t_full))
           + 2 * g.n_embd * g.vocab_size * cfg.max_tokens)  # tied head
    return franky_encode_flops_per_sample(cfg) + gpt


def franky_llama_fwd_flops_per_sample(cfg) -> float:
    """Forward FLOPs of one FrankyLlama sample (encoder, Perceiver, and the
    LLaMA over its causal pairs with its GQA-sized k/v projections)."""
    lm = cfg.lm
    t_full = cfg.brain.n_output_tokens + cfg.max_tokens
    hd = lm.head_dim
    # the stack prices k/v at n_heads * head_dim; LLaMA's use n_kv_heads
    stack = block_stack_fwd_flops(t_full, lm.dim, lm.hidden_dim, lm.n_heads,
                                  hd, lm.n_layers, n_mlp_mats=3,
                                  pairs=_causal_pairs(t_full))
    gqa_save = (lm.n_layers * t_full
                * 2 * lm.dim * 2 * (lm.n_heads - lm.n_kv_heads) * hd)
    head = 2 * lm.dim * lm.vocab_size * cfg.max_tokens
    return franky_encode_flops_per_sample(cfg) + stack - gqa_save + head


def mae_fwd_flops_per_sample(cfg) -> float:
    """MAE pretraining forward: the encoder on the kept tokens (their
    expected visible pairs), the dense decoder on all of them, the head on
    the masked ones."""
    n_tok = cfg.block_size
    n_masked = int(cfg.masking_ratio * n_tok)
    kept = n_tok - n_masked
    enc = (2 * cfg.patch_size * cfg.dim * kept
           + block_stack_fwd_flops(kept, cfg.dim, cfg.hidden_dim, cfg.n_heads,
                                   cfg.head_dim, cfg.n_layers,
                                   pairs=_gathered_pairs(n_tok, kept,
                                                         cfg.n_electrodes)))
    dec = block_stack_fwd_flops(n_tok, cfg.decoder_dim, cfg.hidden_dim,
                                cfg.n_heads, cfg.head_dim, cfg.n_dec_layers)
    head = 2 * cfg.decoder_dim * cfg.patch_size * n_masked
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


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in the trace of the torch.profiler
    recording on this thread (``trace()``, or the benchmark's): a
    ``record_function``, so the span shares the profiler's clock and the
    device operations launched inside it are tied to it by their launches.
    With no profiler recording it is one shared no-op context, and no
    ``RecordFunction`` is built. A span adds no synchronisation and no
    device work."""
    if _profiler_enabled():
        return record_function(name)
    return _NO_SPAN
