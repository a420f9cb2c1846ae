"""frankenstein_tpu_torch — the PyTorch + CUDA port of frankenstein_tpu.

The port serves and trains the flagship Franky on one NVIDIA H100: a
768x256 brain window through the slab-causal encoder and Perceiver, then
GPT-2 124M. Serving: KV-cached top-k or beam-search decode, bf16 or int8 KV
cache, through the predictor, the WER evaluation and the submission writer
(``python -m frankenstein_tpu_torch.submit``). Training: f32 parameters and
bf16 compute, AdamW with a value clip and the warmup-cosine schedule,
checkpoints and resume (``python -m frankenstein_tpu_torch.train``). The
whisper path (``models/whisper.py``: seq2seq decode, greedy, beams and
int8 KV; its fine-tuning CLI ``python -m
frankenstein_tpu_torch.whisper_pipeline``) is plain PyTorch in full, as
the JAX package runs it in XLA. Plain
tensor code is PyTorch; the kernels the JAX package wrote in Pallas on these
paths are hand-written CUDA C++ for Hopper (``csrc/``):

- K1 ``ops/cuda/slab_attention.py``: slab-causal attention with in-kernel
  RoPE (the encoder), K10 its int8-QK-score mode, and K4 beside them, the
  backward, joined in the autograd Function ``SlabRopeAttention``;
- K2 ``ops/cuda/fused_decode.py``: one GPT-2 token through all blocks,
  with a bf16 or an int8 KV cache;
- K3 ``ops/cuda/beam_reorder.py``: the in-place beam-search cache reorder;
- K8 ``ops/cuda/lm_head_topk.py`` (``csrc/lm_head_topk.cu``): a decode
  step's head, top-k and logsumexp without the [B, V] logits
  (``sampling.COMPACT_TOPK``), a persistent TMA-ring wgmma head;
- K6 and K7 ``ops/cuda/flash_attention.py``
  (``csrc/flash_attention_dense.cu``): the MAE's attention over its kept
  tokens, dense attention, and slab-causal attention without RoPE, three
  compile-time mask modes of one family of wgmma passes;
- the packed-attention probes ``ops/cuda/slab_probe.py``: compile-time
  modes of K1's and K10's wgmma forwards, each with one component
  removed, timed by ``tools.attn_probe`` and ``tools.int8_attr_probe``.

Each kernel's wrapper runs a plain PyTorch twin for CPU tensors, so the CPU
tests hold the port to the JAX package. The package imports torch and
numpy, never jax or frankenstein_tpu.
"""

__version__ = "0.1.0"

from frankenstein_tpu_torch import config as config
