"""The yardstick's arithmetic: the H100's peaks, the kernels' operation and
byte bounds, the models' forward FLOPs, and the profiler's kernel families.

Frozen copies of what the program measures itself with, so that a later
change to the program cannot move the yardstick:

- ``_bound``, ``_slab_pairs``, ``_flash_pairs``, ``_decode_bound`` and
  ``PROFILE_FAMILIES`` from ``chip_smoke.py`` (there ``_bound`` :367,
  ``_slab_pairs`` :382, ``_decode_bound`` :633, ``_flash_pairs`` :2026,
  ``PROFILE_FAMILIES`` :326), here taking shapes instead of tensors, with
  K3 and K8 named (the smoke counts them apart); the trace is read from
  its events (``profile.py``), so the smoke's ``_device_us`` has no use
  here;
- the peaks and ``block_stack_fwd_flops`` from
  ``frankenstein_tpu_torch/utils/profiling.py``.

Two counts differ from the program's on purpose:

- attention FLOPs count the (query, key) pairs the mask leaves visible
  (``_slab_pairs`` for the encoder's slab-causal mask, t(t+1)/2 for GPT-2's
  causal one). ``utils/profiling.py:franky_encode_flops_per_sample`` and
  ``block_stack_fwd_flops`` count all T^2 pairs, which overstates the
  encode by about 1.6x;
- a decode step reads the live cache rows (``length + 1`` a row and side),
  as ``_decode_bound`` counts them. ``utils/profiling.py:
  gpt_decode_hbm_bytes`` counts the whole allocated cache.
"""

from __future__ import annotations

import re

# NVIDIA's data sheet for the H100 SXM5 80 GB, dense rates, at its 700 W
# limit (utils/profiling.py:PEAK_FLOPS, PEAK_INT8_OPS, HBM_BW)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12

# kernel name -> family, first match wins (chip_smoke.py:PROFILE_FAMILIES)
PROFILE_FAMILIES = [
    ("K6 fwd", r"flash_attn_fwd_positions"),
    ("K6 bwd dq", r"flash_attn_bwd_dq_positions"),
    ("K6 bwd dk/dv", r"flash_attn_bwd_dkv_positions"),
    ("K7 fwd", r"flash_attn_fwd"),
    ("K7 bwd dq", r"flash_attn_bwd_dq"),
    ("K7 bwd dk/dv", r"flash_attn_bwd_dkv"),
    ("K10", r"slab_rope_attn_fwd_int8|rope_(absmax|quantize)_k"),
    ("K1", r"slab_rope_attn_fwd"),
    ("K4", r"slab_rope_attn_bwd"),
    ("K9", r"fused_norm_swiglu"),
    ("K2", r"gpt2_decode_step"),
    ("K5", r"llama_decode_step"),
    ("K3", r"beam_reorder"),
    ("K8", r"lm_head"),
    ("cuDNN conv", r"cudnn|fprop|dgrad|wgrad|convolve|conv[12]d"),
    ("cuBLAS", r"gemm|xmma|nvjet|cutlass|sm90_"),
    ("AdamW", r"multi_tensor"),
    ("reductions", r"reduce|norm"),
    ("elementwise and copies", r"elementwise|vectorized|copy|fill|cat"),
]


def family(name: str) -> str:
    """The kernel family of a device operation's name, or "other"."""
    for fam, pattern in PROFILE_FAMILIES:
        if re.search(pattern, name, re.IGNORECASE):
            return fam
    return "other"


def _bound(n_bytes: float, n_ops: float, int8_ops: float = 0.0) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the memory rate and the operations over their peaks (bf16 ``n_ops``,
    int8 ``int8_ops``)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS
    return max(t_bytes, t_ops)


def _slab_pairs(t: int, p: int) -> int:
    """(query, key) pairs the slab-causal mask allows over T tokens."""
    return sum(min(t, (i // p + 1) * p) for i in range(t))


def _causal_pairs(t: int) -> int:
    """(query, key) pairs a causal mask allows over T tokens."""
    return t * (t + 1) // 2


def _flash_pairs(mode: str, b: int, t: int, tok_per_time: int = 0) -> int:
    """Visible (query, key) pairs over the batch of one head: the work
    these inputs need (dense, or slab with ``tok_per_time``)."""
    if mode == "dense":
        return b * t * t
    if mode == "slab":
        return b * _slab_pairs(t, tok_per_time)
    raise ValueError(f"unknown mode {mode!r}")


def expected_gathered_pairs(t: int, kept: int, p: int) -> float:
    """Expected visible pairs of the MAE's kept-token encoder ("gathered
    slab" over ``kept`` of ``t`` tokens drawn uniformly without
    replacement): each kept token sees itself, and each other visible pair
    of the full slab mask survives with probability k(k-1) / (t(t-1))."""
    keep_both = kept * (kept - 1) / (t * (t - 1))
    return kept + (_slab_pairs(t, p) - t) * keep_both


# ---- kernels' bounds (seconds a launch) --------------------------------

def k1_bound(b: int, t: int, h: int, d: int, p: int,
             qk_int8: bool = False) -> float:
    """K1 (or K10 with ``qk_int8``): the slab-causal forward over folded
    [B, T, H*D] bf16 q, k, v with the rope tables [T, D] f32 (cos, sin),
    out bf16 and lse [B, H, T] f32; 4 D operations a visible pair and head
    (QK and PV), QK at the int8 rate under K10."""
    e = h * d
    n_bytes = 4 * b * t * e * 2 + 2 * t * d * 4 + b * h * t * 4
    pairs = h * b * _slab_pairs(t, p)
    if qk_int8:
        return _bound(n_bytes, 2 * d * pairs, int8_ops=2 * d * pairs)
    return _bound(n_bytes, 4 * d * pairs)


def k4_bound(b: int, t: int, h: int, d: int, p: int) -> float:
    """K4: the slab-causal backward (pre-pass, dq, dk/dv) over q, k, v,
    out, dout and dq, dk, dv [B, T, H*D] bf16, the rope tables and lse;
    10 D operations a visible pair and head (chip_smoke.py:1414)."""
    e = h * d
    n_bytes = 8 * b * t * e * 2 + 2 * t * d * 4 + b * h * t * 4
    return _bound(n_bytes, 10 * d * h * b * _slab_pairs(t, p))


def k7_dense_bounds(b: int, t: int, h: int, d: int) -> tuple:
    """K7 dense: (forward, backward) seconds a launch over [B, T, H*D] bf16,
    4 D operations a pair and head forward, 10 D backward
    (chip_smoke.py:2138-2140)."""
    e = h * d
    pairs = h * _flash_pairs("dense", b, t)
    fwd = _bound(4 * b * t * e * 2 + b * h * t * 4, 4 * d * pairs)
    bwd = _bound(8 * b * t * e * 2 + 2 * b * h * t * 4, 10 * d * pairs)
    return fwd, bwd


def k2_bound(rows: int, n_layer: int, e: int, length: int, *,
             int8_weights: bool, int8_kv: bool) -> float:
    """K2, one all-layer GPT-2 decode step of ``rows`` batch rows at cache
    ``length`` (``_decode_bound``): x in and out (bf16), every stacked
    weight once (12 E^2 a layer, int8 or bf16; f32 LayerNorm params and
    biases, 13 E a layer; f32 w8a16 scales, 9 E a layer), int8-KV scales,
    the live cache rows of both sides read and the new rows written
    (``length + 1`` a row); 2 operations per weight and row, 4 per q-lane
    and visible cache row (scores and AV)."""
    w_bytes = 1 if int8_weights else 2
    c_bytes = 1 if int8_kv else 2
    n_weights = n_layer * 12 * e * e
    n_bytes = (2 * rows * e * 2 + n_weights * w_bytes + n_layer * 13 * e * 4
               + (n_layer * 9 * e * 4 if int8_weights else 0)
               + (2 * n_layer * e * 4 if int8_kv else 0)
               + 2 * n_layer * rows * (length + 1) * e * c_bytes)
    ops = 2 * rows * n_weights + 4 * n_layer * rows * e * (length + 1)
    return _bound(n_bytes, ops)


# ---- forward FLOPs (visible attention pairs) ----------------------------

def block_stack_fwd_flops(seq: int, dim: int, hidden: int, n_heads: int,
                          head_dim: int, n_layers: int, *, pairs: float,
                          n_mlp_mats: int = 3) -> float:
    """Forward matmul FLOPs of a stack of attention blocks over ``seq``
    tokens: per token and layer the qkv and output projections and the
    MLP's matmuls (3 SwiGLU, 2 GELU); per visible (query, key) pair and
    layer the two attention products (``pairs`` of one head)
    (utils/profiling.py:block_stack_fwd_flops, with pairs for seq^2)."""
    inner = n_heads * head_dim
    per_tok = 2 * dim * 3 * inner + 2 * inner * dim + 2 * dim * hidden * \
        n_mlp_mats
    return float(n_layers) * (seq * per_tok + 4 * inner * pairs)


def encoder_fwd_flops(enc: dict, n_tok: int, pairs: float) -> float:
    """The BrainFormer encoder over ``n_tok`` tokens: patch embedding and
    the blocks."""
    return (2 * enc["patch_size"] * enc["dim"] * n_tok
            + block_stack_fwd_flops(n_tok, enc["dim"], enc["hidden_dim"],
                                    enc["n_heads"], enc["head_dim"],
                                    enc["n_layers"], pairs=pairs))


def franky_encode_flops(brain: dict) -> float:
    """One window through Franky's BrainEncoder: the encoder with its
    slab-causal pairs, the Perceiver's cross and self blocks (dense), the
    output projection."""
    enc = brain["encoder"]
    n_tok = (enc["window_size"] // enc["patch_size"]) * enc["n_electrodes"]
    out = encoder_fwd_flops(enc, n_tok,
                            _slab_pairs(n_tok, enc["n_electrodes"]))
    nq, dim = brain["n_output_tokens"], brain["dim"]
    inner = brain["n_heads"] * brain["head_dim"]
    cross = brain["n_layers"] * (2 * dim * inner * nq + 2 * dim * 2 * inner
                                 * n_tok + 4 * n_tok * inner * nq
                                 + 2 * inner * dim * nq
                                 + 2 * dim * brain["hidden_dim"] * 3 * nq)
    self_blocks = block_stack_fwd_flops(nq, dim, brain["hidden_dim"],
                                        brain["n_heads"], brain["head_dim"],
                                        brain["n_layers"], pairs=nq * nq)
    return out + cross + self_blocks + 2 * dim * brain["output_dim"] * nq


def gpt_fwd_flops(gpt: dict, t: int, head_rows: int) -> float:
    """GPT-2 over ``t`` positions with its causal pairs, the tied head on
    ``head_rows`` of them."""
    e = gpt["n_embd"]
    return (block_stack_fwd_flops(t, e, 4 * e, gpt["n_head"],
                                  e // gpt["n_head"], gpt["n_layer"],
                                  pairs=_causal_pairs(t), n_mlp_mats=2)
            + 2 * e * gpt["vocab_size"] * head_rows)


def gpt_decode_step_flops(gpt: dict, length: int) -> float:
    """One cached decode step of one row at cache ``length``: the block
    matmuls, attention over the ``length + 1`` visible rows, the head."""
    e, n_layer = gpt["n_embd"], gpt["n_layer"]
    return (n_layer * (2 * 12 * e * e + 4 * e * (length + 1))
            + 2 * e * gpt["vocab_size"])


def franky_request_flops(model_config: dict, batch: int, rows: int,
                         new_tokens: int) -> float:
    """Model FLOPs of one served request of ``batch`` windows decoded over
    ``rows`` rows (``batch`` times the beam width, or ``batch``): the
    encode, the prefill of the prefix and the start token, and the
    ``new_tokens - 1`` decode steps that produce the tokens after the
    first."""
    brain, gpt = model_config["brain"], model_config["gpt"]
    t0 = brain["n_output_tokens"] + 1
    decode = sum(gpt_decode_step_flops(gpt, t0 + i)
                 for i in range(new_tokens - 1))
    return (batch * franky_encode_flops(brain)
            + rows * (gpt_fwd_flops(gpt, t0, 1) + decode))


def franky_train_fwd_flops(model_config: dict, max_tokens: int) -> float:
    """One Franky training sample's forward: the encode and GPT-2 over the
    prefix and ``max_tokens`` text positions, the head on the text."""
    brain, gpt = model_config["brain"], model_config["gpt"]
    t = brain["n_output_tokens"] + max_tokens
    return franky_encode_flops(brain) + gpt_fwd_flops(gpt, t, max_tokens)


def mae_fwd_flops(cfg: dict) -> float:
    """One MAE sample's forward: the encoder on the kept tokens (their
    expected visible pairs), the dense decoder on all of them, the head on
    the masked ones."""
    n_tok = (cfg["window_size"] // cfg["patch_size"]) * cfg["n_electrodes"]
    n_masked = int(cfg["masking_ratio"] * n_tok)
    kept = n_tok - n_masked
    enc = encoder_fwd_flops(cfg, kept, expected_gathered_pairs(
        n_tok, kept, cfg["n_electrodes"]))
    dec = block_stack_fwd_flops(n_tok, cfg["decoder_dim"], cfg["hidden_dim"],
                                cfg["n_heads"], cfg["head_dim"],
                                cfg["n_dec_layers"], pairs=n_tok * n_tok)
    return enc + dec + 2 * cfg["decoder_dim"] * cfg["patch_size"] * n_masked
