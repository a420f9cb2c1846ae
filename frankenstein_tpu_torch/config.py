"""Configuration dataclasses of the ported slices.

Field-for-field copies of ``frankenstein_tpu/config.py`` (``MAEConfig``,
``SimpleEncoderConfig``, ``SimpleMAEConfig``, ``PerceiverConfig``,
``GPTConfig``, ``VQVAEConfig``, ``FrankyConfig``, ``WhisperConfig``,
``TrainConfig``, the JSON mixin that lets YAML sections and
``model_config.json`` round-trip, and the constants the slices use), and
of ``LlamaConfig``, ``tiny_llama_config`` (``models/llama.py``) and
``FrankyLlamaConfig`` (``models/franky.py``). The port cannot import those modules, because the
JAX package's ``__init__`` pulls in jax; ``tests/test_torch_config.py``
holds the copies to the originals' fields, defaults and serialization.
``Lfm2MoeConfig`` and ``FrankyLfm2Config`` are the port's own (the JAX
package has no LFM2).
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Optional


class _SerializableMixin:
    """JSON (de)serialization for nested frozen config dataclasses."""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict):
        # ``from __future__ import annotations`` stringifies f.type: resolve
        # the real classes so nested configs rebuild as dataclasses
        hints = typing.get_type_hints(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            t = hints.get(f.name, f.type)
            if isinstance(v, dict) and dataclasses.is_dataclass(t):
                v = t.from_dict(v)
            elif isinstance(v, list):
                v = tuple(v)      # JSON/YAML lists: keep configs hashable
            kwargs[f.name] = v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

MAX_INPUT_LEN = 768   # time bins per trial at 50 Hz (~15.4 s)
MAX_TOKENS = 25       # GPT-2 tokens per sentence incl. bos/eos
N_ELECTRODES = 256    # Utah-array channels (spikePow features)
IGNORE_INDEX = -100   # label padding ignored by the CE loss
GPT2_EOT = 50256      # <|endoftext|>


@dataclass(frozen=True)
class MAEConfig(_SerializableMixin):
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

    # per-session conditioning: n_sessions > 0 adds a learned
    # date_embedding[date_info % n_sessions] to every token
    n_sessions: int = 0

    # sequence parallelism: the encoder's tokens split over the ambient
    # sequence group (parallel/ring_attention.py:seq_group), slab attention
    # round the ring; without a group the same single-device math
    seq_parallel: bool = False

    # int8 QK scores in the encoder's slab attention (kernel K10)
    qk_int8: bool = False

    @property
    def n_patches_per_channel(self) -> int:
        return self.window_size // self.patch_size

    @property
    def block_size(self) -> int:
        """Total token count: time-slabs x electrodes."""
        return self.n_patches_per_channel * self.n_electrodes


@dataclass(frozen=True)
class SimpleEncoderConfig(_SerializableMixin):
    """SimpleMAE's encoder: whole-timestep tokens (all channels of one time
    bin) over ``block_size`` timesteps."""

    block_size: int = 6           # tokens: timesteps of the window
    patch_size: int = 128         # a token's width: the channel count
    dim: int = 256
    n_layers: int = 6
    head_dim: int = 32
    hidden_dim: int = 1024
    n_heads: int = 8
    n_kv_heads: int = 8
    rope_theta: float = 10000.0


@dataclass(frozen=True)
class SimpleMAEConfig(_SerializableMixin):
    """SimpleMAE's decoder."""

    dim: int = 256
    n_layers: int = 2
    head_dim: int = 32
    hidden_dim: int = 1024
    n_heads: int = 8
    n_kv_heads: int = 8
    rope_theta: float = 10000.0
    masking_ratio: float = 0.75


@dataclass(frozen=True)
class PerceiverConfig(_SerializableMixin):
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
class GPTConfig(_SerializableMixin):
    block_size: int = 1024
    vocab_size: int = 50304   # padded to a multiple of 64 (HF ckpt uses 50257)
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    dropout: float = 0.0
    bias: bool = True

    # Mixture-of-Experts MLP (models/moe.py) in every block when > 0
    moe_experts: int = 0
    moe_k: int = 2
    moe_capacity: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


@dataclass(frozen=True)
class VQVAEConfig(_SerializableMixin):
    """The VQ-VAE tokenizer ("SoundStream",
    ``frankenstein_tpu/models/vq_brain.py``)."""

    n_electrodes: int = 512   # spikePow(+tx4) channels into the codec
    C: int = 256              # conv width
    D: int = 64               # latent / codebook dim
    codebook_size: int = 1024
    strides: tuple = (2, 2)   # two stride-2 encoder blocks: 4x downsample

    # the quantizer's knobs (vector_quantize_pytorch's names)
    commitment_weight: float = 0.25
    use_cosine_sim: bool = True
    kmeans_init: bool = True
    ema_decay: float = 0.8
    threshold_ema_dead_code: float = 2.0
    eps: float = 1e-5


@dataclass(frozen=True)
class FrankyConfig(_SerializableMixin):
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


@dataclass(frozen=True)
class LlamaConfig(_SerializableMixin):
    """LLaMA-family decoder (``frankenstein_tpu/models/llama.py``)."""

    vocab_size: int = 128256        # llama-3 defaults
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False

    # Mixture-of-Experts MLP (models/moe.py) in every block when > 0
    moe_experts: int = 0
    moe_k: int = 2
    moe_capacity: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def tiny_llama_config(**kw) -> LlamaConfig:
    base = dict(vocab_size=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                hidden_dim=64, max_seq_len=64)
    base.update(kw)
    return LlamaConfig(**base)


@dataclass(frozen=True)
class FrankyLlamaConfig(_SerializableMixin):
    """Brain prefix -> LLaMA composite (``frankenstein_tpu/models/franky.py``):
    a ~110M LLaMA over GPT-2 BPE ids by default."""

    brain: PerceiverConfig = field(
        default_factory=lambda: PerceiverConfig(
            encoder=MAEConfig(window_size=768, patch_size=32),
            n_output_tokens=32,
            output_dim=1024,
        )
    )
    lm: LlamaConfig = field(
        default_factory=lambda: LlamaConfig(
            vocab_size=50304, dim=1024, n_layers=8, n_heads=16,
            n_kv_heads=8, hidden_dim=2816, rope_theta=10000.0,
            max_seq_len=128, tie_embeddings=True))
    max_tokens: int = MAX_TOKENS
    pad_token_id: int = GPT2_EOT


LFM2_8B_A1B_LAYERS = (
    "conv", "conv", "full_attention", "conv", "conv", "conv",
    "full_attention", "conv", "conv", "conv", "full_attention", "conv",
    "conv", "conv", "full_attention", "conv", "conv", "conv",
    "full_attention", "conv", "conv", "full_attention", "conv", "conv")


@dataclass(frozen=True)
class Lfm2MoeConfig(_SerializableMixin):
    """LFM2-MoE decoder (HF ``lfm2_moe``; ``models/lfm2.py``), LiquidAI's
    LFM2-8B-A1B by default. The fields are HF's ``config.json`` keys, so
    ``from_dict`` reads that file as it is (keys the port does not use are
    ignored)."""

    vocab_size: int = 65536
    hidden_size: int = 2048
    intermediate_size: int = 7168         # the leading dense layers' SwiGLU
    moe_intermediate_size: int = 1792     # each routed expert's SwiGLU
    num_hidden_layers: int = 24
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    layer_types: tuple = LFM2_8B_A1B_LAYERS   # "conv" or "full_attention"
    conv_L_cache: int = 3                 # the short convolution's kernel
    conv_bias: bool = False
    num_dense_layers: int = 2             # leading layers with a dense MLP
    num_experts: int = 32
    num_experts_per_tok: int = 4
    use_expert_bias: bool = True          # a bias that only picks experts
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    rope_theta: float = 1000000.0
    norm_eps: float = 1e-5
    tie_word_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def attention_layers(self) -> tuple:
        """Indices of the GQA attention layers; every other is a conv."""
        return tuple(i for i, t in enumerate(self.layer_types)
                     if t == "full_attention")


@dataclass(frozen=True)
class FrankyLfm2Config(_SerializableMixin):
    """Brain prefix -> LFM2-MoE composite (``models/franky.py:FrankyLfm2``):
    the Perceiver's 32 vectors at the LM's width."""

    brain: PerceiverConfig = field(
        default_factory=lambda: PerceiverConfig(
            encoder=MAEConfig(window_size=768, patch_size=32),
            n_output_tokens=32,
            output_dim=2048,
        )
    )
    lm: Lfm2MoeConfig = field(default_factory=Lfm2MoeConfig)


@dataclass(frozen=True)
class WhisperConfig(_SerializableMixin):
    """Whisper-tiny-like encoder / decoder geometry for the 80 x 3000 "fake
    mel" input (``models/whisper.py``)."""

    n_mels: int = 80
    n_audio_ctx: int = 1500     # 3000 frames / 2 after conv2's stride
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51864
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    dropout: float = 0.0

    # special tokens; -1 = unset (top-of-vocab placeholders).
    # ``params_from_hf_whisper`` fills the real ids of a checkpoint
    decoder_start_token_id: int = -1
    eos_token_id: int = -1
    pad_token: int = -1
    # the full decoder prompt: (sot, lang?, task?, notimestamps?), HF's
    # forced_decoder_ids behind decoder_start_token_id
    sot_sequence: tuple = ()


@dataclass(frozen=True)
class TrainConfig(_SerializableMixin):
    """The trainer's settings (``frankenstein_tpu/config.py:TrainConfig``).
    In the port: ``steps_per_dispatch`` is k optimizer steps per host group
    (same numerics as k single steps); ``mesh_shape`` (data, model) and
    ``fsdp`` lay the run out over a process group
    (``train/trainer.py:setup_parallel``); ``remat`` checkpoints each
    block."""

    exp_name: str = "default"

    batch_size: int = 256          # GLOBAL batch
    grad_accum: int = 1

    # per-sample probability of the time-masking augmentation
    # (train/trainer.py:augment_batch)
    p_augs: float = 0.0

    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    # True => decay only params with ndim >= 2 (matmul weights +
    # embeddings), never biases / norm scales; False => decay everything
    weight_decay_mask: bool = False

    max_steps: int = 100_000
    eval_interval: int = 1_000

    use_scheduler: bool = True
    warmup_iters: int = 2_000
    lr_decay_iters: int = 50_000

    grad_clip: float = 1.0         # clip by VALUE
    # f32 parameters, bf16 compute: float batch inputs are cast to bf16 and
    # the model is built with a bf16 compute dtype
    mixed_precision: bool = True

    seed: int = 42
    log_interval: int = 10
    keep_checkpoints: int = 3

    steps_per_dispatch: int = 1

    # mesh geometry: data x model
    mesh_shape: Optional[tuple] = None   # None => one device

    remat: bool = False

    fsdp: bool = False
