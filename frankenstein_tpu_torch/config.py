"""Configuration dataclasses of the serving slice.

Field-for-field copies of ``frankenstein_tpu/config.py`` (``MAEConfig``,
``PerceiverConfig``, ``GPTConfig``, ``FrankyConfig`` and the constants the
slice uses). JSON serialization is not ported yet. The port cannot import
that module, because the JAX package's ``__init__`` pulls in jax;
``tests/test_torch_config.py`` holds the copies to the originals' fields
and defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field

MAX_INPUT_LEN = 768   # time bins per trial at 50 Hz (~15.4 s)
MAX_TOKENS = 25       # GPT-2 tokens per sentence incl. bos/eos
N_ELECTRODES = 256    # Utah-array channels (spikePow features)
IGNORE_INDEX = -100   # label padding ignored by the CE loss
GPT2_EOT = 50256      # <|endoftext|>


@dataclass(frozen=True)
class MAEConfig:
    """BrainFormer encoder geometry."""

    window_size: int = 1024
    n_electrodes: int = 256
    patch_size: int = 48

    dim: int = 256
    n_layers: int = 4
    head_dim: int = 32
    hidden_dim: int = 1024
    n_heads: int = 8
    n_kv_heads: int = 8
    rope_theta: float = 10000.0

    n_dec_layers: int = 4
    decoder_dim: int = 256

    masking_ratio: float = 0.75

    # per-session conditioning; the port's encoder refuses n_sessions > 0
    n_sessions: int = 0

    # sequence parallelism has no counterpart in the port yet; without a
    # sequence mesh the JAX package computes the same single-device math
    seq_parallel: bool = False

    # int8 QK scores (kernel K10); the port's encoder refuses it
    qk_int8: bool = False

    @property
    def n_patches_per_channel(self) -> int:
        return self.window_size // self.patch_size

    @property
    def block_size(self) -> int:
        """Total token count: time-slabs x electrodes."""
        return self.n_patches_per_channel * self.n_electrodes


@dataclass(frozen=True)
class PerceiverConfig:
    """Perceiver resampler on top of the encoder."""

    encoder: MAEConfig = field(default_factory=MAEConfig)

    n_output_tokens: int = 32
    output_dim: int = 1024

    dim: int = 256  # must equal encoder.dim
    n_layers: int = 2
    head_dim: int = 16
    hidden_dim: int = 512
    n_heads: int = 4
    n_kv_heads: int = 4
    rope_theta: float = 10000.0


@dataclass(frozen=True)
class GPTConfig:
    block_size: int = 1024
    vocab_size: int = 50304   # padded to a multiple of 64 (HF ckpt uses 50257)
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    dropout: float = 0.0
    bias: bool = True

    # Mixture-of-Experts MLP; the port's GPT refuses moe_experts > 0
    moe_experts: int = 0
    moe_k: int = 2
    moe_capacity: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


@dataclass(frozen=True)
class FrankyConfig:
    """Brain prefix -> GPT-2 composite (the flagship serving model)."""

    brain: PerceiverConfig = field(
        default_factory=lambda: PerceiverConfig(
            encoder=MAEConfig(window_size=768, patch_size=32),
            n_output_tokens=32,
            output_dim=768,
        )
    )
    gpt: GPTConfig = field(default_factory=GPTConfig)
    max_tokens: int = MAX_TOKENS
    pad_token_id: int = GPT2_EOT
