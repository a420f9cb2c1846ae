"""Whisper-style encoder-decoder for brain-to-text, the "fake mel" path
(``frankenstein_tpu/models/whisper.py``).

- encoder: conv1d (k3, s1) -> GELU -> conv1d (k3, s2) -> GELU, plus fixed
  sinusoidal positions, then pre-LN blocks and a final LayerNorm;
- decoder: learned positions, causal self-attention, cross-attention over
  the encoder states, a GELU MLP, and the head tied to the token embedding;
- ``forward``: the seq2seq loss over labels padded with -100 (the decoder
  inputs are the labels shifted right behind the start token);
- the KV-cached decode: ``prefill`` encodes once and computes each layer's
  cross K/V; ``decode_step`` runs one token against the self-attention
  cache, float or int8 (``WhisperQuantCache``). Beams keep the cross K/V
  at batch B (``expand_cache``, ``reorder_cache``): the W beams of a
  sentence fold into the query axis of the cross attention.

Parameter names are HF's (``model.encoder.conv1``,
``model.encoder.layers.{i}.self_attn.q_proj``, ...,
``model.decoder.layer_norm``; ``proj_out`` tied to
``model.decoder.embed_tokens``), so an HF checkpoint loads by name
(``params_from_hf_whisper``); the JAX package's flax tree comes across
through ``models/weights.py:whisper_state_from_flax``.

``dtype`` is the compute dtype (``models/layers.py``). As in the JAX
package, a LayerNorm's output takes its f32 weight's dtype, so under bf16
compute the encoder's output and the decoder's final norm are f32 and the
tied head is an f32 product; the cross K/V come out of a bf16 projection.
No attention here reaches a kernel: the encoder's 1500 frames are under
``ops/attention.py:DENSE_FLASH_MIN`` and the decoder's causal and cross
attention run the plain path, in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from frankenstein_tpu_torch.config import IGNORE_INDEX, WhisperConfig
from frankenstein_tpu_torch.models.gpt2 import cross_entropy_ignore
from frankenstein_tpu_torch.models.layers import LayerNorm, linear, run_block
from frankenstein_tpu_torch.ops import attention as attn_ops
from frankenstein_tpu_torch.ops.cuda.fused_decode import quantize_rows

# the JAX importer drops HF's encoder position table: the port computes it
_HF_ENCODER_POSITIONS = "model.encoder.embed_positions.weight"


def sinusoids(length: int, channels: int,
              max_timescale: float = 10000.0) -> torch.Tensor:
    """Whisper's fixed sinusoidal embedding [length, channels] (sin | cos),
    computed in float64 and rounded to f32."""
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)],
                                           axis=1)).float()


def _put_rows(cache: torch.Tensor, rows: torch.Tensor,
              start: int) -> torch.Tensor:
    """A copy of ``cache`` [B, S, ...] with rows [start, start + t) set to
    ``rows`` (``dynamic_update_slice``: the input is left as it was)."""
    out = cache.clone()
    out[:, start:start + rows.shape[1]] = rows.to(cache.dtype)
    return out


class WhisperAttention(nn.Module):
    """Multi-head attention: q, v and out have a bias, k has none."""

    def __init__(self, dim: int, n_head: int, device=None, dtype=None):
        super().__init__()
        self.dim, self.n_head = dim, n_head
        self.compute_dtype = dtype
        self.q_proj = nn.Linear(dim, dim, device=device)
        self.k_proj = nn.Linear(dim, dim, bias=False, device=device)
        self.v_proj = nn.Linear(dim, dim, device=device)
        self.out_proj = nn.Linear(dim, dim, device=device)

    def _proj(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return linear(x, layer, self.compute_dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.n_head, self.dim // self.n_head)

    def _out(self, out: torch.Tensor, b: int, t: int) -> torch.Tensor:
        return self._proj(self.out_proj, out.reshape(b, t, self.dim))

    def forward(self, x, context=None, *, causal: bool = False):
        ctx = x if context is None else context
        q = self._split(self._proj(self.q_proj, x))
        k, v = self.kv(ctx)
        out = attn_ops.dot_product_attention(
            q, k, v, mask_mode="causal" if causal else None)
        return self._out(out, x.shape[0], x.shape[1])

    def kv(self, ctx):
        return (self._split(self._proj(self.k_proj, ctx)),
                self._split(self._proj(self.v_proj, ctx)))

    def cached_self(self, x, k_cache, v_cache, length: int, k_scale=None,
                    v_scale=None):
        """Self-attention of x's t rows against the cache, their keys and
        values written at rows [length, length + t). Returns (out, k_cache,
        v_cache), the caches new tensors. With int8 caches (``k_scale`` /
        ``v_scale`` [1, 1, H, D] f32 given) attention runs on the
        dequantized cache with the FLOAT new rows, and the cache stores the
        new rows' codes under the same frozen scales; older codes stay as
        they are."""
        q = self._split(self._proj(self.q_proj, x))
        k, v = self.kv(x)
        if k_scale is not None:
            dt = q.dtype
            kf = _put_rows(k_cache.to(dt) * k_scale.to(dt), k, length)
            vf = _put_rows(v_cache.to(dt) * v_scale.to(dt), v, length)
            k_cache = _put_rows(k_cache, quantize_rows(k, k_scale), length)
            v_cache = _put_rows(v_cache, quantize_rows(v, v_scale), length)
        else:
            k_cache = _put_rows(k_cache, k, length)
            v_cache = _put_rows(v_cache, v, length)
            kf, vf = k_cache, v_cache
        out = attn_ops.cached_attention(q, kf, vf, length + 1)
        return self._out(out, x.shape[0], x.shape[1]), k_cache, v_cache

    def cross_from_kv(self, x, k, v):
        """Cross attention against precomputed K/V [B, T_enc, H, D]. When x
        has more rows than k / v (B*W beams over an unreplicated cross
        cache, ``BrainWhisper.expand_cache``), each sentence's W one-token
        queries fold into the query axis, [B, W, H, D], against its one
        encoding: the replicated computation, re-batched."""
        q = self._split(self._proj(self.q_proj, x))
        bw, t = x.shape[0], x.shape[1]
        b = k.shape[0]
        if bw != b:
            w = bw // b
            if t != 1 or b * w != bw:
                raise ValueError(f"grouped cross attention needs one token "
                                 f"a row and B*W rows: x {tuple(x.shape)}, "
                                 f"k {tuple(k.shape)}")
            q = q.reshape(b, w, self.n_head, self.dim // self.n_head)
        out = attn_ops.dot_product_attention(q, k, v)
        return self._out(out, bw, t)


class _Layer(nn.Module):
    """The parts both block kinds share: self-attention and the GELU MLP
    (``fc1``, ``fc2``), each behind its LayerNorm."""

    def __init__(self, dim: int, n_head: int, device=None, dtype=None):
        super().__init__()
        self.compute_dtype = dtype
        self.self_attn_layer_norm = LayerNorm(dim, device=device)
        self.self_attn = WhisperAttention(dim, n_head, device, dtype)
        self.final_layer_norm = LayerNorm(dim, device=device)
        self.fc1 = nn.Linear(dim, 4 * dim, device=device)
        self.fc2 = nn.Linear(4 * dim, dim, device=device)

    def _with_mlp(self, x):
        """x plus the MLP of its final LayerNorm."""
        cdt = self.compute_dtype
        h = F.gelu(linear(self.final_layer_norm(x), self.fc1, cdt),
                   approximate="none")
        return x + linear(h, self.fc2, cdt)


class EncoderLayer(_Layer):
    def forward(self, x):
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return self._with_mlp(x)


class DecoderLayer(_Layer):
    def __init__(self, dim: int, n_head: int, device=None, dtype=None):
        super().__init__(dim, n_head, device, dtype)
        self.encoder_attn_layer_norm = LayerNorm(dim, device=device)
        self.encoder_attn = WhisperAttention(dim, n_head, device, dtype)

    def forward(self, x, enc):
        x = x + self.self_attn(self.self_attn_layer_norm(x), causal=True)
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), enc)
        return self._with_mlp(x)

    def cached(self, x, enc_k, enc_v, k_cache, v_cache, length: int,
               k_scale=None, v_scale=None):
        """The block over x's rows against the self-attention cache and the
        cross K/V. Returns (x, k_cache, v_cache)."""
        h, k_cache, v_cache = self.self_attn.cached_self(
            self.self_attn_layer_norm(x), k_cache, v_cache, length, k_scale,
            v_scale)
        x = x + h
        x = x + self.encoder_attn.cross_from_kv(
            self.encoder_attn_layer_norm(x), enc_k, enc_v)
        return self._with_mlp(x), k_cache, v_cache

    def cross_kv(self, enc):
        return self.encoder_attn.kv(enc)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None, dtype=None):
        super().__init__()
        d = cfg.n_audio_state
        self.compute_dtype = dtype
        self.conv1 = nn.Conv1d(cfg.n_mels, d, 3, padding=1, device=device)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1, device=device)
        self.layers = nn.ModuleList(
            EncoderLayer(d, cfg.n_audio_head, device, dtype)
            for _ in range(cfg.n_audio_layer))
        self.layer_norm = LayerNorm(d, device=device)
        self.register_buffer("positions", sinusoids(cfg.n_audio_ctx, d).to(
            device or "cpu"), persistent=False)

    def _conv(self, x, conv: nn.Conv1d):
        cdt = self.compute_dtype or conv.weight.dtype
        return F.gelu(F.conv1d(x.to(cdt), conv.weight.to(cdt),
                               conv.bias.to(cdt), stride=conv.stride,
                               padding=conv.padding), approximate="none")

    def forward(self, mel, remat: bool = False):
        """mel [B, n_mels, frames] -> [B, frames // 2, dim], frames at most
        2 * n_audio_ctx."""
        x = self._conv(self._conv(mel, self.conv1), self.conv2).transpose(1, 2)
        x = x + self.positions[:x.shape[1]].to(x.dtype)
        for layer in self.layers:
            x = run_block(layer, x, remat=remat)
        return self.layer_norm(x)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None, dtype=None):
        super().__init__()
        d = cfg.n_text_state
        self.compute_dtype = dtype
        self.embed_tokens = nn.Embedding(cfg.n_vocab, d, device=device)
        self.embed_positions = nn.Embedding(cfg.n_text_ctx, d, device=device)
        self.layers = nn.ModuleList(
            DecoderLayer(d, cfg.n_text_head, device, dtype)
            for _ in range(cfg.n_text_layer))
        self.layer_norm = LayerNorm(d, device=device)

    def embed(self, tokens, start: int = 0):
        """Token plus position embedding of tokens [B, t] at positions
        [start, start + t), summed in f32, then in the compute dtype."""
        t = tokens.shape[1]
        x = (self.embed_tokens(tokens)
             + self.embed_positions.weight[start:start + t][None])
        return x.to(self.compute_dtype or x.dtype)

    def head(self, x):
        """The final LayerNorm, then the tied head as an f32 product."""
        x = self.layer_norm(x)
        return F.linear(x.float(),
                        self.embed_tokens.weight.to(x.dtype).float())


class WhisperQuantCache(NamedTuple):
    """int8 decode state: self-KV codes (and cross-KV codes when quantized)
    with frozen per-(layer, head, dim) scales. [0] / [1] / [2] are the
    float cache's (ks, vs, cross). Built by ``quantize_whisper_cache``
    after prefill."""

    ks: tuple            # per layer [B*W, S, H, D] int8
    vs: tuple
    cross: tuple         # per layer (k, v): int8 codes when quantized
    k_scales: tuple      # per layer [1, 1, H, D] f32
    v_scales: tuple
    cross_scales: tuple  # per layer (sk, sv) when cross is int8, else ()


class BrainWhisper(nn.Module):
    """Seq2seq model over [B, n_mels, frames] inputs (channel first)."""

    def __init__(self, cfg: WhisperConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.remat = False      # the trainer's contract
        self.model = nn.ModuleDict({
            "encoder": WhisperEncoder(cfg, device, dtype),
            "decoder": WhisperDecoder(cfg, device, dtype)})
        self.proj_out = nn.Linear(cfg.n_text_state, cfg.n_vocab, bias=False,
                                  device="meta")
        self.proj_out.weight = self.model["decoder"].embed_tokens.weight

    @property
    def device(self) -> torch.device:
        return self.proj_out.weight.device

    @property
    def decoder(self) -> WhisperDecoder:
        return self.model["decoder"]

    def encode(self, mel):
        """mel [B, n_mels, frames] -> [B, frames // 2, dim]."""
        return self.model["encoder"](mel, remat=self.remat)

    def decode(self, tokens, enc):
        """tokens [B, T] -> f32 logits [B, T, vocab]."""
        x = self.decoder.embed(tokens)
        for layer in self.decoder.layers:
            x = run_block(layer, x, enc, remat=self.remat)
        return self.decoder.head(x)

    def forward(self, mel, labels=None, date_info=None,
                decoder_input_ids=None, *, train: bool = False,
                generator=None):
        """(loss, logits). Without ``decoder_input_ids`` the decoder reads
        the labels shifted right behind the start token, -100 read as the
        pad id (HF's convention); the loss is the mean CE over the labels
        that are not -100. ``date_info``, ``train`` and ``generator`` are
        the trainer's contract and are ignored: no session embedding, no
        dropout."""
        enc = self.encode(mel)
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("BrainWhisper needs labels or "
                                 "decoder_input_ids")
            start = torch.full((labels.shape[0], 1), self.sot_id(),
                               dtype=labels.dtype, device=labels.device)
            shifted = torch.cat([start, labels[:, :-1]], dim=1)
            decoder_input_ids = torch.where(
                shifted == IGNORE_INDEX,
                torch.full_like(shifted, self.pad_id()), shifted)
        logits = self.decode(decoder_input_ids, enc)
        if labels is None:
            return None, logits
        return cross_entropy_ignore(logits, labels, IGNORE_INDEX), logits

    def sot_id(self) -> int:
        """Start of transcript: the checkpoint's, else a top-of-vocab
        placeholder."""
        c = self.cfg
        return (c.decoder_start_token_id if c.decoder_start_token_id >= 0
                else c.n_vocab - 3)

    def eot_id(self) -> int:
        c = self.cfg
        return c.eos_token_id if c.eos_token_id >= 0 else c.n_vocab - 2

    def pad_id(self) -> int:
        c = self.cfg
        return c.pad_token if c.pad_token >= 0 else c.n_vocab - 1

    def sot_prompt(self) -> tuple:
        """The decoder prompt: the start token, and HF's forced ids
        (language, task, notimestamps) when known."""
        return (tuple(self.cfg.sot_sequence) if self.cfg.sot_sequence
                else (self.sot_id(),))

    # ---------------- KV-cached decode ----------------

    @torch.no_grad()
    def prefill(self, tokens, mel, cache):
        """Encode ``mel``, compute each layer's cross K/V once, run the
        prompt ``tokens`` [B, T] through the cached blocks from an empty
        ``cache`` (``init_whisper_cache``). Returns (the last row's f32
        logits [B, vocab], (ks, vs, cross), T)."""
        enc = self.encode(mel)
        layers = self.decoder.layers
        cross = [layer.cross_kv(enc) for layer in layers]
        x = self.decoder.embed(tokens)
        ks, vs = list(cache[0]), list(cache[1])
        for i, layer in enumerate(layers):
            x, ks[i], vs[i] = layer.cached(x, *cross[i], ks[i], vs[i], 0)
        logits = self.decoder.head(x[:, -1:])[:, 0]
        return logits, (ks, vs, cross), tokens.shape[1]

    @torch.no_grad()
    def decode_step(self, token, cache, length: int, qweights=None):
        """One cached decoder step for token [B] at position ``length``.
        ``cache``: the float (ks, vs, cross) from ``prefill`` or a
        ``WhisperQuantCache``; either may hold the cross K/V at batch B
        under B*W beam rows (``expand_cache``). Returns (f32 logits
        [B, vocab], the new cache, length + 1).

        ``qweights`` is the beam loops' positional argument: w8a16 is not
        plumbed for whisper (the decoder's weights are a small share of a
        step's bytes next to the cross and self K/V streams), so anything
        but None raises; int8 KV is its quantization."""
        if qweights is not None:
            raise NotImplementedError(
                "w8a16 is not supported on the whisper path (decoder "
                "weights are ~4% of step bytes; use "
                "quantize_whisper_cache for int8 KV instead)")
        quant = isinstance(cache, WhisperQuantCache)
        ks, vs, cross = list(cache[0]), list(cache[1]), cache[2]
        x = self.decoder.embed(token[:, None], length)
        for i, layer in enumerate(self.decoder.layers):
            ck, cv = cross[i]
            if quant and cache.cross_scales:
                sk, sv = cache.cross_scales[i]
                ck = ck.to(x.dtype) * sk.to(x.dtype)
                cv = cv.to(x.dtype) * sv.to(x.dtype)
            scales = ((cache.k_scales[i], cache.v_scales[i]) if quant
                      else (None, None))
            x, ks[i], vs[i] = layer.cached(x, ck, cv, ks[i], vs[i], length,
                                           *scales)
        logits = self.decoder.head(x)[:, 0]
        new_cache = (cache._replace(ks=tuple(ks), vs=tuple(vs)) if quant
                     else (ks, vs, cross))
        return logits, new_cache, length + 1

    @staticmethod
    def expand_cache(cache, w: int):
        """A batch-B prefilled state replicated to B*W beam rows
        (``decode/sampling.py:_beam_expand``), the self-KV only: the cross
        K/V stay at batch B and ``cross_from_kv`` reads them for all W
        beams of a sentence."""
        rep = lambda c: c.repeat_interleave(w, dim=0)
        if isinstance(cache, WhisperQuantCache):
            return cache._replace(ks=tuple(rep(k) for k in cache.ks),
                                  vs=tuple(rep(v) for v in cache.vs))
        ks, vs, cross = cache
        return ([rep(k) for k in ks], [rep(v) for v in vs], cross)

    @staticmethod
    def reorder_cache(cache, flat_idx, group: int = 0):
        """Beam-parent reorder (``decode/sampling.py:_reorder``): gather
        the self-KV rows only. Beam parents never leave their sentence's
        group, and the cross K/V of a group are one encoding (one row after
        ``expand_cache``), so they are left as they are. int8 codes gather
        like any dtype; the scales have no batch axis."""
        take = lambda c: c.index_select(0, flat_idx)
        if isinstance(cache, WhisperQuantCache):
            return cache._replace(ks=tuple(take(k) for k in cache.ks),
                                  vs=tuple(take(v) for v in cache.vs))
        ks, vs, cross = cache
        return ([take(k) for k in ks], [take(v) for v in vs], cross)


def quantize_whisper_cache(cache, quant_cross: bool = True
                           ) -> WhisperQuantCache:
    """(ks, vs, cross) float prefill state -> ``WhisperQuantCache``:
    symmetric absmax int8 over (batch, position) for each (head, dim)
    channel, scale = max(absmax, 1e-6) / 127, codes rounded half to even
    and clipped to +-127. ``quant_cross`` quantizes the cross K/V too."""
    def q_side(c):
        cf = c.float()
        s = (torch.clamp(cf.abs().amax(dim=(0, 1)), min=1e-6)
             / 127.0)[None, None]                        # [1, 1, H, D]
        return quantize_rows(cf, s), s

    ks, vs, cross = cache
    k8, ksc = zip(*(q_side(k) for k in ks))
    v8, vsc = zip(*(q_side(v) for v in vs))
    if quant_cross:
        cq = [(q_side(ck), q_side(cv)) for ck, cv in cross]
        cross8 = tuple((ck8, cv8) for (ck8, _), (cv8, _) in cq)
        csc = tuple((sk, sv) for (_, sk), (_, sv) in cq)
    else:
        cross8, csc = tuple(cross), ()
    return WhisperQuantCache(tuple(k8), tuple(v8), cross8, tuple(ksc),
                             tuple(vsc), csc)


def init_whisper_cache(cfg: WhisperConfig, batch: int, max_len: int,
                       dtype=torch.float32, device=None):
    """Empty self-attention caches: (ks, vs), each a list of one
    [batch, max_len, H, D] tensor a decoder layer."""
    shape = (batch, max_len, cfg.n_text_head,
             cfg.n_text_state // cfg.n_text_head)
    zeros = lambda: [torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(cfg.n_text_layer)]
    return zeros(), zeros()


def params_from_hf_whisper(hf_model):
    """A ``transformers.WhisperForConditionalGeneration`` (a local
    checkpoint or one built from a config; nothing is downloaded) as
    (state, cfg): its state dict by HF's names as numpy arrays, less the
    encoder's position table (the port computes ``sinusoids``), and the
    ``WhisperConfig`` with its special tokens and its ``sot_sequence``
    (the start token, then ``generation_config.forced_decoder_ids``, else
    the model config's, in position order)."""
    state = {k: v.detach().cpu().numpy()
             for k, v in hf_model.state_dict().items()
             if k != _HF_ENCODER_POSITIONS}
    hc = hf_model.config

    def tok(name):
        v = getattr(hc, name, None)
        return -1 if v is None else int(v)

    gen = getattr(hf_model, "generation_config", None)
    forced = ((getattr(gen, "forced_decoder_ids", None) if gen is not None
               else None) or getattr(hc, "forced_decoder_ids", None) or [])
    sot = tok("decoder_start_token_id")
    sot_seq = ((sot,) + tuple(int(t) for _, t in sorted(forced))
               if sot >= 0 else ())
    cfg = WhisperConfig(
        n_mels=hc.num_mel_bins, n_audio_ctx=hc.max_source_positions,
        n_audio_state=hc.d_model, n_audio_head=hc.encoder_attention_heads,
        n_audio_layer=hc.encoder_layers, n_vocab=hc.vocab_size,
        n_text_ctx=hc.max_target_positions, n_text_state=hc.d_model,
        n_text_head=hc.decoder_attention_heads,
        n_text_layer=hc.decoder_layers, decoder_start_token_id=sot,
        eos_token_id=tok("eos_token_id"), pad_token=tok("pad_token_id"),
        sot_sequence=sot_seq)
    return state, cfg
