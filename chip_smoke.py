"""Chip smoke test of the PyTorch + CUDA port (``frankenstein_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``frankenstein_tpu_torch/csrc`` with
nvcc (sm_90a) and then, one line per phase:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the kernel build time;
2. kernel K1 (slab-causal RoPE attention: a rotation pre-pass, then a
   wgmma forward) against its plain PyTorch twin at the flagship encoder
   shape (B=2, T=6144, H=8, D=32) at P=256 (its unmasked instance), P=96
   (its masked one) and P=192 (the two warpgroups of a CTA ending at
   different keys): out, lse, two launches bitwise equal; then K1 and SDPA
   (bool slab mask, rotated q, k) in turns at B=2 and B=32, both back to
   back at B=2 and B=128, K1 back to back at B=2, 32 and 128 beside its
   exp floor and issued TFLOP/s, the masked instance's times, the
   pre-pass's and the forward's ms (torch.profiler), each kernel's
   registers and CTAs an SM, and the twin's time;
3. kernel K2 (all-layer GPT-2 decode step: one persistent cooperative
   launch a token, ``csrc/decode_common.cuh``) against its twin at GPT-2
   124M width, bf16 and w8a16 weights, two launches bitwise equal, with
   both times a token at B=8 and B=128 beside the bound, the achieved GB/s,
   the launch (grid, registers, CTAs an SM, spills from ``build.log``, ring
   slots, depth splits), the device operations a call (torch.profiler: 1)
   and, for w8a16 at B=8, one token's split into products, attention, rows
   / act and barrier waits (the kernel's %globaltimer stamps);
4. the flagship Franky served end to end through ``make_franky_predictor``
   (random weights from a seed, bf16, w8a16 decode, top-k 10), with the
   launch counts of the kernels (K9 = 4 encoder blocks + 2 Perceiver
   self-attention blocks per encode), output checks, an f32 CPU
   cross-check of the chain, and encode / decode times at batch 128, the
   encode with K9 on and off (``fused_mlp.ENABLED``) in turns, with its
   peak memory, and one B=8 request's device time by kernel family;
5. kernel K3 (beam-search cache reorder) against its twin at the flagship
   beam shape, bf16 and int8, and at FrankyLlama's int8 beam cache
   [8, 160, 64, 512], bitwise, with both times;
6. kernel K2's int8-KV mode against its twin at GPT-2 124M width, B*W=160
   and B=8, bf16 and w8a16 weights, two launches bitwise equal, with both
   times and phase 3's launch numbers (the phase split for w8a16);
7. the beam path: the same flagship served through ``make_franky_predictor
   (beam_width=5, int8_kv=True, int8_weights=True)`` at batch 32, with the
   launch counts of K1, K2 (int8-KV mode), K3 and K9, beam width 1 against
   greedy, the int8-KV logits against the bf16 cache's,
   ``evaluate_franky_wer`` over a synthetic set, the submission writer,
   encode / beam decode / request times and one request's device time by
   kernel family;
8. kernel K4 (the backward of K1: a rotation pre-pass, a dq pass and a
   dk/dv pass) against its twin at the flagship encoder shape, at P=256
   (its unmasked instance) and P=96 (its masked one): dq, dk, dv, the
   pre-pass's qr and kr (bitwise) and delta, the probability rows it
   recomputes (each sums to 1 against K1's lse), two launches bitwise
   equal; then at P=256 the kernel and SDPA's backward in turns at B=2
   and B=32, the kernel back to back, its bound, exp floor, issued
   TFLOP/s and each pass's registers and CTAs an SM;
9. training: the flagship Franky (f32 parameters, bf16 compute) trained
   for 30 steps at B=32 on synthetic trials through the train CLI
   (``python -m frankenstein_tpu_torch.train --config configs/franky.yaml``,
   called in-process), with an eval and a checkpoint: finite, falling
   losses, the launch counts of K1, K4 and K9, one step's gradients against
   an f32 CPU twin at B=1, the checkpoint restored bitwise, the run served
   by ``python -m frankenstein_tpu_torch.submit --run-dir`` over 8
   synthetic windows; then the step time, samples/s and peak memory at
   B=32, with K9 on and off in turns, and one step at the YAML's batch 256
   with grad_accum 8;
10. kernel K5 (all-layer LLaMA decode step, GQA over the unexpanded cache)
    against its twin in all four modes: at FrankyLlama width (L=8, E=1024,
    16 heads on 8 KV heads, F=2816, S=64) with B*W=160 and an int8 cache
    (w8a16 and bf16 weights) and B=32 with a bf16 cache (bf16 and w8a16),
    and at a 1B-class shape (E=2048, head_dim 128, F=5632, L=16, B=8, S=48,
    bf16 and w8a16): errors, int8 codes (equal to the twin's off ties in
    layer 0, at most one apart deeper), the exact rounding rule, a 3-step
    chain across row 8, two launches bitwise equal, both times and phase
    3's launch numbers (the phase split for w8a16 at B*W=160 and B=8);
    and, after phase 23, ``python -m frankenstein_tpu_torch.tools.
    decode_sweep profile`` in a child process of its own (K2 and K5 at the
    decode paths' five shapes): exactly one device operation a call, the
    kernel's own (in this long process torch.profiler may drop a record,
    so phases 3, 6 and 10 hold the operations only to the kernel's name;
    the child runs last because, started while this process's profiler
    is initialised, it makes this process's later profiles drop records);
11. FrankyLlama (``configs/franky_llama.yaml``'s model: the flagship encoder,
    a 2-layer Perceiver into a ~110M LLaMA) served end to end through
    ``make_franky_predictor(beam_width=5, int8_kv=True, int8_weights=True,
    rescorer=(fl,))`` at batch 32 (random weights from a seed, bf16): the
    launch counts of K1, K5 (int8-KV mode), K3 and K9, whether the rescorer
    moved a row off its first beam, beam width 1 against greedy, the int8-KV
    logits against a bf16 cache's, an f32 CPU cross-check, the top-k path,
    and the median and range over 5 runs of encode / beam decode / rescore
    (timed stage by stage within one chain) and of the whole request, and
    one request's device time by kernel family;
12. kernels K6 (flash attention over a gathered token subset: key j visible
    to query i iff slab(pos[j]) <= slab(pos[i])) and K7 (dense, and
    slab-causal without RoPE) against their twins, forward and backward:
    K6 at the MAE encoder's shape (B=2, 1536 of 6144 tokens kept by
    ``masking_indices``), K7 at B=2, T=6144; out, lse, dq, dk, dv, the
    probability rows the backward recomputes (each sums to 1 against the
    forward's lse), two launches bitwise equal, kernel, twin and SDPA times,
    and the kernels and SDPA (K6 with its bool mask, K7 dense unmasked) at
    B=32 (the ``kernels`` line's ``ms`` and ``library_ms`` are the B=2
    times back to back, as every entry's, with the medians in turns
    beside them as ``ms_in_turns`` and ``library_ms_in_turns``); then K7
    slab (the slab mode of the same wgmma passes) at P=256,
    96 and 8 and head_dim 32 and 64, forward and backward against the
    twins, two backward launches bitwise equal, and each slab pass's
    registers and CTAs an SM, unmasked and masked instance;
13. MAE pretraining: ``configs/mae.yaml``'s MAE (f32 parameters, bf16
    compute) trained for 30 steps at B=32 through the train CLI, with an
    eval and a checkpoint: finite, falling losses, the launch counts of K6
    and K7 (4 forward per forward pass, 4 backward per step) and K9 (4 per
    forward pass: the encoder's blocks; the decoder's residual stream is
    f32, which K9's gate refuses), K1-K5 and the twins idle, the checkpoint
    restored bitwise, ``return_preds`` shaped as
    the window, one step's gradients against an f32 CPU twin at B=1 with the
    same mask (at the seeded initial weights, and after training, where
    each attention weight is held to what bf16 compute on the CPU gives
    it) and that step's K6 / K7 backward launches against their twins on
    the same tensors, the step time, samples/s and peak memory at B=32
    (with K9 on and off in turns) and one step at B=256 with grad_accum 8;
    then ``configs/franky.yaml``
    trained for 2 steps with ``--init-encoder-from`` the MAE run, its
    encoder equal to the MAE checkpoint's bitwise before the first step;
    last, a torch.profiler split of the MAE's and the grafted Franky's B=32
    step by kernel family (K6's three passes each a family the MAE's must
    show);
14. kernel K9 (the fused pre-norm SwiGLU MLP, wgmma products on weights
    streamed by TMA) against its twin, LayerNorm and RMSNorm, at the
    flagship encoder's shape (T=6144, E=256, hidden 1024) at B=2, 32 and
    128 (its one- and two-warpgroup instances) and the Perceiver's (B=128,
    T=32, hidden 512): out and the update out - x, two launches bitwise
    equal, the kernel's, the twin's and the eager module chain's times (no
    one library call computes the function), the kernel's issued TFLOP/s,
    registers and CTAs an SM;
15. the routes the kernels do not take, through the train CLI at B=1: one
    ``--no-bf16`` step of Franky and of the MAE (f32: no kernel launches,
    plain attention at T=6144, the MLPs' module chain) and one bf16 step of
    an MAE of ``--channels 100`` (2400 tokens, 600 kept: K6 and K7 refuse
    them, K9 runs); finite losses, the launch counts and the plain calls;
16. kernel K8 (the decode step's ln_f + tied head + top-k + logsumexp:
    a LayerNorm pre-pass, then a persistent TMA-ring wgmma head with a
    grid barrier and a merge) against its twin at GPT-2 124M width (E=768,
    V=50304), bf16, k=10, at B=8, 32, 128 and 160 (beams' B*W): vals,
    logz, indices (a difference only at a near-tie), two launches bitwise
    equal, each launch's device time (torch.profiler) beside the bound,
    the launch (batch width, ring stages, registers, spills), the kernel's,
    the twin's and the eager chain's times, and the port's dense route at
    B=128; then B=1, k=32 at B=160, a table of width 1024, a ragged vocab
    whose true top-k lies in its last block's tail, and a forced tie;
17. kernel K10 (K1's forward with int8 QK scores: a K pre-pass, a Q
    pre-pass, an int8-wgmma forward) against its twin and against K1 at
    the flagship encoder shape (B=2, T=6144, H=8, D=32, P=256): K codes
    and scales, out (relative to max |twin|) and lse, the same check failed
    by K1's output and by a K10 that reads chunk 0's K scale for every
    tile, the drift of out from K1's, K10 + K4 gradients against the
    twins' chain, two launches bitwise equal, K10's and K1's times in
    turns, K10 without its K pre-pass and the K pre-pass alone, both back
    to back at B=2, 32 and 128 beside K10's exp floor and issued TOP/s,
    the B=32 call split by kernel (torch.profiler), and each K10 kernel's
    registers and CTAs an SM;
18. the flagship served with bf16 block weights through
    ``make_franky_predictor(top_k=10)`` at B=128 and B=8 with
    ``sampling.COMPACT_TOPK`` and ``qk_int8`` on (K8 = 25 and K10 = 4 per
    request, K1 = 0) and off (K8 = K10 = 0), and a B=8 request with both
    on and ``int8_kv`` (K2's int8-KV mode = K8 = 25), under
    FK_QK_INT8_STRICT=1: one decode step's K8 top-k against the dense
    route's on the same bf16 cache and on the same int8 one, the B=8 encoder
    context through K10 against K1's, the encode, the decode and the B=8
    request timed in turns with each switch on and off (medians of 5 and
    their ranges, sentences/s at B=128), and one Franky training step at
    B=2 with ``qk_int8`` (K10 forward, K4 backward);
19. the packed-attention probes (``ops/cuda/slab_probe.py``: compile-time
    modes of K1's and K10's wgmma forwards, on unrotated q, k): every mode
    at B=2, T=6144, H=8, D=32 against its twin (P=8 and P=256; the int8
    modes at P=256); K1 with identity rope tables bitwise equal to the
    ``kernel`` mode (out and lse, P=8 and 256) and within K1_TOL of its
    twin; K10 on those tables bitwise equal to ``int8_full`` (P=256), both
    within K10's tolerances of K10's twin, with bitwise equal K and Q codes
    and scales; ``no_kbd`` finite, repeatable and unlike ``kernel``; then
    the two probe CLIs as a user runs them at B=128 (``attn_probe`` at P=8
    and P=256, ``int8_attr_probe`` at P=256), one line per variant with
    its median time, its twin error at B=2 and B=128, its bound and its
    issued TFLOP/s, ``kernel`` beside K1 less its rotation pre-pass and
    ``int8_full`` beside K10, and each mode's registers and CTAs an SM;
20. the remaining training paths, through the train CLI in-process:
    FrankyLlama (``configs/franky_llama.yaml``, 20 steps at B=32 with an
    eval and a checkpoint, ``--init-encoder-from`` phase 13's MAE run):
    the encoder equal to the MAE checkpoint's bitwise before the first
    step, finite falling losses, K1 = 4 and K9 = 6 launches a forward pass
    and K4 = 4 a step, the checkpoint restored bitwise, ``submit
    --run-dir`` over 8 synthetic windows, one step's gradients at B=1
    against an f32 CPU twin, and the B=32 step's median and range and
    peak memory; SimpleMAE (``--model simple_mae --window 768 --channels
    256``, 20 steps at B=32): padded timesteps in the windows, finite
    falling losses, the encoder's and decoder's residual dtypes and K9's
    RMSNorm launches the gate gives them (the encoder's bf16 blocks; the
    decoder's stream is f32), K1, K4, K6 and K7 idle and every attention
    on the plain path (the padding masks), the checkpoint restored
    bitwise, B=1 gradients against an f32 CPU twin with the same mask, and
    the B=32 step with K9 on and off in turns; BrainFormer at the train
    CLI's geometry (25 x 50257 outputs) forward and backward at B=8 with
    float targets against its f32 CPU twin, K1, K4 and K9 launched, and
    its B=32 train step's median and range and peak memory; one Franky
    step at B=2 with 24 sessions and per-sample ``date_info``, where
    exactly the used ``date_embedding`` rows get a gradient;
21. the whisper path (``models/whisper.py``) at whisper-tiny width (80 x
    3000 input, 4 + 4 layers of width 384, bf16 compute, seeded weights),
    which no kernel of the port serves: 64 synthetic windows prepared on
    the card (``data/whisper_prep.py``: PCA-80, 2x FFT resample, pad to
    3000); the card's prefill and 24 teacher-forced decode-step logits at
    B=2 against an f32 CPU twin, beside bf16 on the CPU; a B=32 greedy
    request (prefill, then ``greedy_decode_scan`` for 25 tokens) and a
    B=32 beam-of-5 request over int8 self and cross KV, medians and ranges
    of 5 in turns with their peaks, the cross K/V at batch 32 after
    ``expand_cache`` and every reorder, and the greedy request's device
    time by kernel family; ``evaluate_seq2seq_wer`` over the 64 windows,
    greedy and with beams; the fine-tuning pipeline
    (``whisper_pipeline.build``, then ``run_train_model``) for 20 steps at
    B=16 with one WER eval and a checkpoint: finite falling losses, the
    checkpoint restored bitwise, the step's median and range and peak, and
    B=1 gradients against an f32 CPU twin beside bf16 on the CPU; every
    kernel launch counter (K1-K10) at 0 through the phase;
22. the VQ-VAE and the rest: ``configs/vqvae.yaml``'s SoundStream (768 x
    512 windows, C=256, D=64, K=1024; f32 parameters, bf16 convs, the
    quantizer in f32) trained for 30 steps at B=64 through the train CLI
    at the YAML's lr after a 5-step warm-up, logging every step, with an
    eval every 10 and a checkpoint: finite losses, val falling at each
    eval and the last 10 steps' mean under the first's, ``perplexity``,
    ``rec_loss``, ``commit_loss`` and ``mfu`` in ``metrics.jsonl``, no
    kernel launched, the checkpoint restored bitwise, codebook buffers
    included; a fresh model's first step (initted 0 -> 1, k-means, the
    refresh); the refresh of the trained model at B=64 against a
    recomputation (each dead code a batch row's l2norm at size 1, the
    rest the EMA update); B=1 steps on four padded windows with the
    trained codebook written and read back as a reference file and
    ``threshold_ema_dead_code=0`` (no draws), against an f32 CPU twin
    (the loss and its terms within VQ_LOSS_TOL, which two injected faults
    must exceed; gradients and the codebook's update off near-ties within
    twice bf16 on the CPU's), with f32 on the card beside them;
    ``get_quantize_vectors`` against the twin off near-ties; the B=64 step
    (median and range of 5, peak, MFU), one B=256 step and its profile by
    kernel family. Then the flagship Franky through ``stream_predict`` over
    a 4096 x 256 recording (417 windows, stride 8, 53 calls of 8): K1 = 4
    and K9 = 6 launches a call, each window's prefix against a direct
    encode, windows/s; ``utils/profiling.py``'s peaks for this card and a
    ``trace()`` of one encode; the flagship's weights as a reference
    ``.safetensors`` through ``convert_reference`` and served by ``submit
    --checkpoint`` over 8 windows, and written back by ``--reverse``;
23. the parallel modes and MoE: (a) ``configs/moe_gpt.yaml`` (the flagship
    encoder and Perceiver into GPT-2 124M with a top-2 MoESwiGLU of 8
    experts, hidden 3072, in every block; f32 parameters, bf16 compute)
    trained for 30 steps at B=32 through the train CLI with ``--mesh 1,1``
    after a 5-step lr warm-up, logging every step: finite losses, the
    last 10 steps' mean under the first 10's, launches K1 = 4 and K9 = 6
    a forward, K4 = 4 a step, K2 = 0; the step's median and range of 5,
    samples/s and the peak; (b) ``submit --run-dir`` on the run over 32
    windows with beams of 5, and one B=32 request of the predictor (bf16
    weights): K3 = 25, K1 = 4, K9 = 6, K2 = 0 a request, its median and
    range of 5; the predictor with ``int8_weights=True`` raises; (c) the
    trained MoE GPT on 4 windows' prefixes at B=1 on the card against its
    f32 CPU twin, beside bf16 on the CPU: the logits' relative error
    (within the larger of SLICE_TOL and WITNESS_FACTOR times bf16 on the
    CPU's: bf16 activations flip near-tied routes, on either device) and
    the share of (token, layer) routes whose expert sets are the twin's
    (at most MOE_ROUTE_SLACK under bf16 on the CPU's); then with every
    route pinned to the twin's choice (``models.moe.stable_topk`` patched
    for the call), the card's logits within WITNESS_FACTOR times bf16 on
    the CPU's with the same routes;
    (d) a one-rank NCCL group through the trainer's DDP and FSDP paths: 3
    f32 steps of the MoE Franky (encoder cut to a 96 x 256 window), each
    loss within 1e-5 rel of the unwrapped step's; 3 f32 steps at B=64 of a
    fresh SoundStream at phase 22's geometry through DDP (k-means on the
    first, cuDNN deterministic), each loss and the four codebook buffers
    within 1e-5 rel of an unwrapped copy's; (e) the dryrun
    (``python -m frankenstein_tpu_torch.dryrun --ranks 4 --device cpu``)
    on this machine's torch: its seven ``ok`` lines;
24. the routed experts' route and combine kernels (``ops/cuda/
    moe_route.py``) at the LFM2 cell's shapes (dim 2048, 32 experts, top
    4, a bf16 gate and bias): N = 160 rows (a decode step) and 160 x 33
    (the prefill). The route kernel's offsets, rows and positions against
    the twin's stable sort of its own choices, its choices and weights
    against the twin's on cuBLAS's f32 scores (on the rows whose top 5
    picks lie more than 1e-5 apart, at least 90% of them), the combine
    kernel within one bf16 rounding of its twin; then, back to
    back, each kernel, its twin and the PyTorch chain it replaces (f32
    GEMM, sigmoid, topk, gather, normalisation, stable sort, searchsorted,
    the running count's add; index_copy_, the weights' cast, bmm) as
    ``ms``, ``plain_ms`` and ``library_ms``, and each kernel and the chain
    as one call of a CUDA graph of 20 (``graph_ms``, as the cell's step
    graphs run them), beside the byte bound. Last, the launches on the
    cell's own path: an LFM2 at full width cut to 4 layers (2 routed),
    bf16, its prefill of 160 x 33 rows and a decode step of 160 rows
    replayed from its CUDA graph, each counted from zero: one route and
    one combine launch a routed layer (the ``kernels`` line's
    ``launches``, of the replayed step).

Every on / off comparison (phases 4, 9, 13, 17, 18 and 20) is timed by
``_in_turns``: one warm-up each, then single calls alternating in turns,
as medians and ranges of TIMING_REPEATS.

Then one JSON line with the kernels' results (each with its bound, the least
time the card could take for the same bytes and operations, and the time of
one PyTorch library call computing the same function where there is one),
and as the last line ``{"ok": true, "device": {...}}``. Any failure raises:
non-zero exit and no ``ok`` line. Without a CUDA device it exits non-zero
before printing a result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

from frankenstein_tpu_torch.utils import profiling

SEED = 0
K1_TOL = 3e-2     # bf16 kernel vs f32 twin: rotated q/k and p round to bf16
K2_TOL = 2e-2     # relative to max |twin|: same roundings, other f32 order
SLICE_TOL = 1e-1  # bf16 card chain vs f32 CPU twins, relative to max |ref|
CODE_WINDOW = 1e-3  # how near a .5 tie a value counts as a tie
INT8_KV_TOL = 5e-2  # int8 vs bf16 cache logits, relative to the logit range
K4_TOL = 2e-2     # relative to max |twin|: ds, p, dq, dk round to bf16
ROWSUM_TOL = 1e-2   # |sum of a recomputed probability row - 1|
GRAD_TOL = 5e-2   # bf16 card step vs f32 CPU twin, relative (norms)
WITNESS_FACTOR = 2  # trained MAE: a weight's card error may reach this
                    # times the bf16 CPU twins' own (two bf16 runs of other
                    # summation orders each sit about as far from f32)
TRAIN_STEPS = 30
TIMING_REPEATS = 5  # timed runs of each phase-11 stage and request
K5_TOL = 2e-2     # relative to max |twin|: the same bf16 roundings, other
                  # f32 summation order
FLASH_TOL = 2e-2  # K6 / K7, relative to max |twin|: p, ds, dq, dk and dv
                  # round to bf16
K9_TOL = 2e-2     # relative to max |twin|: a, b and g round to bf16 after
                  # f32 sums taken in another order
PROFILE_STEPS = 3   # profiled B=32 train steps (phase 13)
PROFILE_TOP = 4     # kernels named in a profile line
# kernel name -> family, first match wins
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
    ("cuDNN conv", r"cudnn|fprop|dgrad|wgrad|convolve|conv[12]d"),
    ("cuBLAS", r"gemm|xmma|nvjet|cutlass|sm90_"),
    ("AdamW", r"multi_tensor"),
    ("reductions", r"reduce|norm"),
    ("elementwise and copies", r"elementwise|vectorized|copy|fill|cat"),
]
K8_TOL = 3e-3     # K8 vs its twin on the same bf16 inputs: h rounds to bf16
                  # after f32 statistics summed in other orders
ROUTE_TOL = 2e-2  # K8's top-k vs the dense route's on one decode state: the
                  # two round h at different points (ops/norms.py)
K10_OUT_TOL = 1e-2   # K10 vs its twin, out relative to max |twin|: out
                     # rounds to bf16 (2^-9 relative), p to bf16 before AV
K10_LSE_TOL = 1e-4   # K10 vs its twin, lse absolute: the same integer dots
                     # dequantized in the same order, f32 sums in another
QK_INT8_DRIFT = 1e-2  # K10 vs K1 out, max abs at unit-scale activations
                      # (the JAX package's bound, tests/test_attention.py)
ENCODE_DRIFT = 5e-2   # K10 vs K1 encoder context, max abs relative to
                      # max |K1's|: 4 layers of that drift, rounded to bf16
PROBE_BATCH = 128         # the probes' timed shape, the JAX tools' B
PROBE_TWIN_ROWS = 2       # batch rows of a probe output held to its twin
# the H100 SXM's rates, NVIDIA's data sheet (utils/profiling.py)
HBM_BYTES_PER_S = profiling.HBM_BW[profiling.H100_SXM]
BF16_OPS_PER_S = profiling.PEAK_FLOPS[profiling.H100_SXM]   # dense
EXP2_PER_S = 132 * 16 * 1.83e9   # ex2 a second: 16 a clock an SM at the
                                 # clock of the bf16 peak (K6 / K7 exp floor)
INT8_OPS_PER_S = profiling.PEAK_INT8_OPS[profiling.H100_SXM]   # dense


def _bound(n_bytes: float, n_ops: float, int8_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peaks (bf16 ``n_ops``,
    int8 ``int8_ops``)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / BF16_OPS_PER_S + int8_ops / INT8_OPS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _slab_pairs(t: int, p: int) -> int:
    """(query, key) pairs the slab-causal mask allows over T tokens."""
    return sum(min(t, (i // p + 1) * p) for i in range(t))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_each_ms(fn, iters: int = 0, warmup: int = 1) -> list:
    """Each of ``iters`` (TIMING_REPEATS by default) calls of fn() timed on
    its own between CUDA events, for calls whose host work varies."""
    import torch
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(iters or TIMING_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _spread(ms) -> tuple:
    """(median, min, max) of a list of times."""
    s = sorted(ms)
    return s[len(s) // 2], s[0], s[-1]


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_card(card: str) -> None:
    import torch
    from frankenstein_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    build.library()
    built = (f"built in {build.build_seconds:.2f} s"
             if build.build_seconds is not None else "reused an earlier build")
    print(f"phase 1 card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} | kernels "
          f"{built}, ready after {time.perf_counter() - t0:.2f} s", flush=True)


def _k1_inputs(b: int, gen, t: int = 6144, h: int = 8, d: int = 32):
    """Flagship encoder attention: bf16 q, k, v [B, T, E] and the rope
    tables."""
    import torch
    from frankenstein_tpu_torch.ops import rope
    dev = torch.device("cuda")
    q, k, v = (torch.randn(b, t, h * d, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    cos, sin = rope.folded_tables(rope.build_rope_cache(d, t, device=dev),
                                  1)
    return q, k, v, cos, sin


def _k1_checks(args, h: int, p: int) -> dict:
    """K1 with slabs of ``p`` tokens against its f32 twin (out and lse,
    absolute, within K1_TOL), finite, and two launches bitwise equal.
    Raises where a check fails."""
    import torch
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    kw = dict(n_heads=h, tok_per_time=p)
    out, lse = k1.slab_rope_attention(*args, **kw)
    again = k1.slab_rope_attention(*args, **kw)
    ref_out, ref_lse = k1.slab_rope_attention_ref(
        *(x.float() for x in args[:3]), *args[3:], **kw)
    torch.cuda.synchronize()
    err_out, err_lse = _max_err(out, ref_out), _max_err(lse, ref_lse)
    bitwise = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    where = f"K1 at P={p}"
    _check(bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
           f"{where}: output not finite")
    _check(err_out <= K1_TOL and err_lse <= K1_TOL,
           f"{where} disagrees with its twin: out {err_out}, lse {err_lse}")
    _check(bitwise, f"{where} is not deterministic")
    return {"out": out, "lse": lse, "err_out": err_out, "err_lse": err_lse,
            "rel_out": err_out / float(ref_out.abs().max()),
            "rel_lse": err_lse / float(ref_lse.abs().max()),
            "bitwise": bitwise}


def _by_kernel(fn, pattern: str, want: set, calls: int = 3) -> dict:
    """Device ms a call of each kernel whose name ``pattern`` matches (its
    group 1 names it) over ``calls`` calls of ``fn`` (torch.profiler),
    after one warm-up; raises unless every name of ``want`` ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        found = re.search(pattern, e.key)
        if found:
            name = found.group(1)
            out[name] = out.get(name, 0.0) + _device_us(e) / 1e3 / calls
    _check(set(out) == want, f"the profile of {sorted(want)} found "
           f"{sorted(out)}")
    return out


def phase_k1(card: str) -> dict:
    """K1 against its twin at the flagship shape, at P=256 (the unmasked
    instance), P=96 (the masked one) and P=192 (unmasked, the two
    warpgroups of a 128-row CTA ending at different keys): out, lse, two
    launches bitwise equal; then at P=256 K1 and SDPA (bool slab mask,
    rotated q, k) in turns (``_in_turns``) at B=2 and B=32 and back to
    back at B=128, K1 back to back at B=2, 32 and 128 beside its bound,
    exp floor (one ex2 a visible pair at EXP2_PER_S) and issued TFLOP/s
    (4·D ops a visible pair), the masked instance back to back, the
    pre-pass's and the forward's ms (torch.profiler) and each kernel's
    registers and CTAs an SM."""
    import torch
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    b, t, h, d, p = 2, 6144, 8, 32, 256
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    args = _k1_inputs(b, gen)
    q, k, v, cos, sin = args
    kw = dict(n_heads=h, tok_per_time=p)
    checks = {pp: _k1_checks(args, h, pp) for pp in (p, 96, 192)}
    main = checks[p]
    fwd = lambda a, pp=p: (lambda: k1.slab_rope_attention(
        *a, n_heads=h, tok_per_time=pp))
    sdpa = lambda a: _sdpa(*_sdpa_heads(*a, h), _slab_mask(t, p, a[0].device))
    timed = {2: _in_turns({"K1": fwd(args), "SDPA": sdpa(args)})}
    ms = {2: _time_ms(fwd(args))}
    sdpa_ms = {2: _time_ms(sdpa(args), iters=3)}
    ms_masked = {2: _time_ms(fwd(args, 96))}
    plain_ms = _time_ms(lambda: k1.slab_rope_attention_ref(*args, **kw),
                        iters=3)
    bound = _bound(_nbytes(q, k, v, cos, sin, main["out"], main["lse"]),
                   4 * d * h * b * _slab_pairs(t, p))
    pairs = {bb: h * bb * _slab_pairs(t, p) for bb in (2, 32, 128)}
    occ = {("prep", p): k1.fwd_occupancy("prep", d, p)}
    occ.update({("fwd", pp): k1.fwd_occupancy("fwd", d, pp)
                for pp in (p, 96)})
    bargs = _k1_inputs(32, gen)
    timed[32] = _in_turns({"K1": fwd(bargs), "SDPA": sdpa(bargs)})
    ms[32] = _time_ms(fwd(bargs), iters=5)
    ms_masked[32] = _time_ms(fwd(bargs, 96), iters=5)
    passes = _by_kernel(fwd(bargs), r"slab_rope_attn_fwd_(prep|wgmma)",
                        {"prep", "wgmma"})
    del bargs
    bargs = _k1_inputs(128, gen)
    ms[128] = _time_ms(fwd(bargs), iters=3)
    sdpa_ms[128] = _time_ms(sdpa(bargs), iters=3)
    del bargs
    floor = {bb: n / EXP2_PER_S * 1e3 for bb, n in pairs.items()}
    at = lambda bb: (f"B={bb}: kernel back to back {ms[bb]:.3f} ms, exp "
                     f"floor {floor[bb]:.4f} ms, issued "
                     f"{4 * d * pairs[bb] / ms[bb] / 1e9:.1f} TFLOP/s")
    print(f"phase 2 K1 slab_rope_attention B={b} T={t} E={h * d} H={h} "
          f"D={d} bf16 | " + " | ".join(
              f"P={pp}{' (masked instance)' if pp == 96 else ''}: out "
              f"max_abs_err {c['err_out']:.3e} (rel {c['rel_out']:.3e}), lse "
              f"max_abs_err {c['err_lse']:.3e} (rel {c['rel_lse']:.3e}), "
              f"two launches bitwise equal {c['bitwise']}"
              for pp, c in checks.items()) +
          f" | tol {K1_TOL} | P={p} in turns, medians (range) of "
          f"{TIMING_REPEATS}: B=2 kernel {_ms_note(timed[2], 'K1')} ms, SDPA "
          f"with the slab mask {_ms_note(timed[2], 'SDPA')} ms; B=32 kernel "
          f"{_ms_note(timed[32], 'K1')} ms, SDPA "
          f"{_ms_note(timed[32], 'SDPA')} ms | " +
          " | ".join(at(bb) for bb in (2, 32, 128)) +
          f" | SDPA back to back: B=2 {sdpa_ms[2]:.3f} ms, B=128 "
          f"{sdpa_ms[128]:.3f} ms | P=96 (masked) "
          f"back to back: B=2 {ms_masked[2]:.3f} ms, B=32 "
          f"{ms_masked[32]:.3f} ms | B=32 by kernel (torch.profiler, ms a "
          f"call): pre-pass {passes['prep']:.3f}, forward "
          f"{passes['wgmma']:.3f} | plain {plain_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}) | registers / "
          f"CTAs an SM: " + ", ".join(f"{pas} P={pp} {r} / {c}"
                                      for (pas, pp), (r, c) in occ.items()) +
          f" | {card}", flush=True)
    return {"max_abs_err": max(main["err_out"], main["err_lse"]),
            "ms": ms[2], "plain_ms": plain_ms, "ms_b32": ms[32],
            "ms_b128": ms[128], "library_ms": sdpa_ms[2],
            **bound}


def _heads(x, h):
    """[B, T, E] -> [B, H, T, D]."""
    b, t, e = x.shape
    return x.reshape(b, t, h, e // h).transpose(1, 2)


def _sdpa_heads(q, k, v, cos, sin, h):
    """[B, T, E] -> [B, H, T, D], q and k rotated (the kernel's RoPE)."""
    from frankenstein_tpu_torch.ops import rope
    return (rope.apply_rope_folded(_heads(q, h), cos, sin),
            rope.apply_rope_folded(_heads(k, h), cos, sin), _heads(v, h))


def _slab_mask(t: int, p: int, dev):
    """[T, T] bool: query i may see key j when slab(j) <= slab(i)."""
    import torch
    i = torch.arange(t, device=dev)
    return (i[None, :] // p) <= (i[:, None] // p)


def _sdpa(qh, kh, vh, mask, dout=None):
    """One ``scaled_dot_product_attention`` call on [B, H, T, D] q, k, v
    with a bool mask (None: unmasked), the library yardstick of K1, K4, K6
    and K7 (never used by the port): its forward thunk, or with ``dout``
    [B, T, E] the thunk of its backward."""
    import torch
    import torch.nn.functional as F
    if dout is None:
        return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=mask)
    qh, kh, vh = (a.detach().requires_grad_() for a in (qh, kh, vh))
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    dh = _heads(dout, qh.shape[1])
    return lambda: torch.autograd.grad(out, (qh, kh, vh), dh,
                                       retain_graph=True)


def _decode_bound(x, st: dict, mats, kc, length: int, scales=()) -> dict:
    """Bound of an all-layer decode step (K2, K5): x in and out, every
    stacked weight, the live cache rows of both sides read and the new rows
    written, once; 2 operations per weight and batch row, and 4 per cached
    q-lane (scores and AV) over the live rows plus the new one."""
    n_layer, b, _, e_kv = kc.shape
    width = x.shape[1]
    rows = 2 * n_layer * b * (length + 1) * e_kv * kc.element_size()
    n_bytes = (2 * _nbytes(x) + sum(_nbytes(t) for t in st.values())
               + _nbytes(*scales) + rows)
    n_weights = sum(st[key].numel() for key in mats)
    ops = 2 * b * n_weights + 4 * n_layer * b * width * (length + 1)
    return {**_bound(n_bytes, ops), "bytes": n_bytes}


def _spills(kernel: str) -> int:
    """The most bytes of spill stores ptxas reported (``build.log``) for any
    instance of ``kernel``."""
    from frankenstein_tpu_torch.ops.cuda import build
    log = (build.BUILD_DIR / "build.log").read_text().splitlines()
    most = 0
    for i, line in enumerate(log):
        if "Function properties for" in line and kernel in line:
            found = re.search(r"(\d+) bytes spill stores", log[i + 1])
            most = max(most, int(found.group(1)) if found else 0)
    return most


def _decode_report(fn, ms: float, bound: dict, info: dict, kernel: str,
                   split: bool = False) -> tuple:
    """(a note, its numbers) for an all-layer decode call: the achieved
    GB/s of its bound's bytes, the launch (grid, registers, CTAs an SM,
    spills), the device operations a call (torch.profiler; 1 for the
    persistent kernel) and, with ``split``, one token's ms in products,
    attention, rows / act and barrier waits (the kernel's %globaltimer
    stamps, mean over the CTAs)."""
    from frankenstein_tpu_torch.tools import decode_sweep
    ops, by_kernel = decode_sweep.kernel_split(fn, calls=3)
    spills = _spills(kernel)
    gbs = bound["bytes"] / (ms * 1e-3) / 1e9
    parts = decode_sweep.phase_split(fn) if split else None
    note = (f"{gbs:.1f} GB/s of the bound's bytes, grid {info['grid']} "
            f"({info['ctas_per_sm']} CTAs an SM, {info['registers']} "
            f"registers, {spills} bytes spilled, ring {info['ring']}, "
            f"splits {info['splits']}), {ops:g} device operations a call")
    if parts is not None:
        note += ", a token's ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items())
    # only the kernel's own operations (late in a long process the profiler
    # may drop a kernel's record, so the count is printed as read here and
    # held to exactly one a call in a fresh process: _decode_profile)
    _check(all(kernel in k for k in by_kernel),
           f"{kernel}: {ops} device operations a call ({by_kernel})")
    return note, {"gbs": gbs, "device_ops": ops, "split_ms": parts,
                  "spills": spills, **info}


DECODE_PROFILE_S = 600   # the child process of _decode_profile
DECODE_KERNELS = {"K2": "gpt2_decode_step", "K5": "llama_decode_step"}


def _decode_profile(card: str) -> list:
    """``python -m frankenstein_tpu_torch.tools.decode_sweep profile`` in a
    child process of its own (K2 at GPT-2 124M width, K5 at FrankyLlama
    width, its five decode shapes): each JSON line must show exactly one
    device operation a call, the kernel's own. A failing or timed-out child
    fails the smoke. ``main`` runs it after every other phase: once this
    process has used torch.profiler, such a child makes its later profiles
    drop records (phase 17 found three of K10's four kernels)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "frankenstein_tpu_torch.tools.decode_sweep",
         "profile"], cwd=repo, capture_output=True, text=True, check=True,
        timeout=DECODE_PROFILE_S)
    took = time.perf_counter() - t0
    rows = [json.loads(line) for line in run.stdout.splitlines()
            if line.startswith("{")]
    _check(len(rows) == 5, f"decode_sweep profile printed {len(rows)} "
           f"lines:\n{run.stdout}\n{run.stderr[-2000:]}")
    for r in rows:
        name = DECODE_KERNELS[r["kernel"]]
        _check(r["device_ops_per_call"] == 1
               and list(r["kernels_ms"]) and all(
                   name in k for k in r["kernels_ms"]),
               f"{r['kernel']} B={r['batch']}: "
               f"{r['device_ops_per_call']} device operations a call "
               f"({r['kernels_ms']}), want exactly one, {name}'s")
    print(f"phase 10 decode profile (python -m frankenstein_tpu_torch.tools."
          f"decode_sweep profile, a child process, {took:.1f} s): " +
          ", ".join(f"{r['kernel']} B={r['batch']} {r['weights']} weights "
                    f"{r['cache']} cache {r['device_ops_per_call']:g} device "
                    f"operation a call ({', '.join(r['kernels_ms'])}), "
                    f"{r['ms_per_token']:.4f} ms a token"
                    for r in rows) + f" | {card}", flush=True)
    return rows


def _k2_inputs(b: int, gen, w8: bool):
    import torch
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    n_layer, e, s = 12, 768, 64
    dev = torch.device("cuda")
    rnd = lambda *shape, sc: torch.randn(*shape, generator=gen,
                                         device=dev) * sc
    vec = {"ln1_w": e, "ln1_b": e, "qkv_b": 3 * e, "proj_b": e,
           "ln2_w": e, "ln2_b": e, "fc_b": 4 * e, "fc2_b": e}
    st = {key: rnd(n_layer, n, sc=0.02) for key, n in vec.items()}
    st["ln1_w"] += 1.0
    st["ln2_w"] += 1.0
    for key, (i, o) in {"qkv_w": (e, 3 * e), "proj_w": (e, e),
                        "fc_w": (e, 4 * e), "fc2_w": (4 * e, e)}.items():
        st[key] = rnd(n_layer, i, o, sc=0.02).to(torch.bfloat16)
    if w8:
        st = k2.quantize_weights(st)
    kc = rnd(n_layer, b, s, e, sc=1.0).to(torch.bfloat16)
    vc = rnd(n_layer, b, s, e, sc=1.0).to(torch.bfloat16)
    x = rnd(b, e, sc=1.0).to(torch.bfloat16)
    return x, st, kc, vc


def phase_k2(card: str) -> dict:
    import torch
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    b, length, n_head = 8, 33, 12
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for mode, w8 in (("bf16", False), ("w8a16", True)):
        x, st, kc, vc = _k2_inputs(b, gen, w8)
        kc_k, vc_k = kc.clone(), vc.clone()
        kc_a, vc_a = kc.clone(), vc.clone()
        kc_r, vc_r = kc.clone(), vc.clone()
        xo, _, _ = k2.fused_decode_blocks(x, st, kc_k, vc_k, length,
                                          n_head=n_head)
        xa, _, _ = k2.fused_decode_blocks(x, st, kc_a, vc_a, length,
                                          n_head=n_head)
        xr, _, _ = k2.fused_decode_blocks_ref(x, st, kc_r, vc_r, length,
                                              n_head=n_head)
        torch.cuda.synchronize()
        bitwise = (torch.equal(xo, xa) and torch.equal(kc_k, kc_a)
                   and torch.equal(vc_k, vc_a))
        scale = float(xr.float().abs().max())
        err_x = _max_err(xo, xr)
        err_row = max(_max_err(kc_k[:, :, length], kc_r[:, :, length]),
                      _max_err(vc_k[:, :, length], vc_r[:, :, length]))
        row_scale = float(kc_r[:, :, length].float().abs().max())
        others = [r for r in range(kc.shape[2]) if r != length]
        untouched = (torch.equal(kc_k[:, :, others], kc[:, :, others])
                     and torch.equal(vc_k[:, :, others], vc[:, :, others]))
        ms = _time_ms(lambda: k2.fused_decode_blocks(x, st, kc_k, vc_k,
                                                     length, n_head=n_head))
        plain_ms = _time_ms(lambda: k2.fused_decode_blocks_ref(
            x, st, kc_r, vc_r, length, n_head=n_head))
        bound = _decode_bound(x, st, k2.WEIGHT_KEYS, kc, length)
        note, launch = _decode_report(
            lambda: k2.fused_decode_blocks(x, st, kc_a, vc_a, length,
                                           n_head=n_head), ms, bound,
            k2.launch_info(12, b, kc.shape[2], 768, n_head, w8, False),
            "gpt2_decode_step", split=w8)
        xb, stb, kcb, vcb = _k2_inputs(128, gen, w8)
        ms_b128 = _time_ms(lambda: k2.fused_decode_blocks(
            xb, stb, kcb, vcb, length, n_head=n_head))
        plain_b128 = _time_ms(lambda: k2.fused_decode_blocks_ref(
            xb, stb, kcb, vcb, length, n_head=n_head))
        bound_b128 = _decode_bound(xb, stb, k2.WEIGHT_KEYS, kcb, length)
        note_b128, _ = _decode_report(
            lambda: k2.fused_decode_blocks(xb, stb, kcb, vcb, length,
                                           n_head=n_head), ms_b128,
            bound_b128,
            k2.launch_info(12, 128, kcb.shape[2], 768, n_head, w8, False),
            "gpt2_decode_step")
        print(f"phase 3 K2 fused_decode_blocks {mode} L=12 E=768 H=12 S=64 "
              f"B={b} length={length}: x_out max_abs_err {err_x:.3e} "
              f"(max|x| {scale:.3f}), new-row max_abs_err {err_row:.3e} "
              f"(max|row| {row_scale:.3f}), other rows untouched "
              f"{untouched}, two launches bitwise equal {bitwise}, tol "
              f"{K2_TOL} x max | kernel {ms:.4f} ms a token, plain "
              f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}), {note} | B=128 kernel {ms_b128:.4f} "
              f"ms, plain {plain_b128:.4f} ms, bound "
              f"{bound_b128['bound_ms']:.4f} ms, {note_b128} | {card}",
              flush=True)
        _check(torch.isfinite(xo).all(), f"K2 {mode} output not finite")
        _check(bitwise, f"K2 {mode} is not deterministic")
        _check(err_x <= K2_TOL * scale and err_row <= K2_TOL * row_scale,
               f"K2 {mode} disagrees with its twin: x {err_x}, row {err_row}")
        _check(untouched, f"K2 {mode} wrote outside row {length}")
        results[mode] = {"max_abs_err": max(err_x, err_row), "ms": ms,
                         "plain_ms": plain_ms, "ms_b128": ms_b128,
                         "plain_ms_b128": plain_b128, "launch": launch,
                         **bound}
    return results


def _cpu_cross_check(model, xs) -> dict:
    """The chain on the card (kernels, bf16) against the same weights as
    f32 on the CPU (the kernels' twins): prefix, prefill logits and 3
    greedy decode steps' logits, each relative to max |CPU value|."""
    import copy

    import torch
    from frankenstein_tpu_torch.decode import sampling
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    x = xs[:1]
    errs = {}

    def run(m, xin):
        prefix = m.encode(xin)
        idx0 = torch.full((1, 1), 50256, dtype=torch.long, device=xin.device)
        cache = m.init_decode_cache(1, 64)
        logits, cache, length = m.prefill(idx0, prefix, cache)
        qw = sampling.decode_weights(m, int8_weights=False)
        steps = [logits]
        tok = torch.argmax(logits, dim=-1)
        for _ in range(3):
            logits, cache, length = m.decode_step(tok, cache, length, qw)
            steps.append(logits)
        return prefix, steps, tok

    with torch.no_grad():
        g_prefix, g_steps, _ = run(model, x)
        c_prefix, c_steps, _ = run(ref, x.cpu())
    errs["prefix"] = _max_err(g_prefix.cpu(), c_prefix) / float(
        c_prefix.abs().max())
    errs["logits"] = max(_max_err(g.cpu(), c) / float(c.abs().max())
                         for g, c in zip(g_steps, c_steps))
    return errs


def _qk_int8_config(cfg):
    """``cfg`` (a FrankyConfig) with ``qk_int8`` on in its encoder."""
    import dataclasses
    brain = cfg.brain
    return dataclasses.replace(cfg, brain=dataclasses.replace(
        brain, encoder=dataclasses.replace(brain.encoder, qk_int8=True)))


def _flagship(qk_int8: bool = False):
    """The flagship Franky on the card: random weights from SEED, bf16;
    with ``qk_int8`` the same weights with the encoder's int8 QK scores."""
    import torch
    from frankenstein_tpu_torch.config import FrankyConfig
    from frankenstein_tpu_torch.decode import pipeline
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.models.weights import init_franky_
    cfg = _qk_int8_config(FrankyConfig()) if qk_int8 else FrankyConfig()
    model = init_franky_(Franky(cfg, device=torch.device("cuda")), seed=SEED)
    return pipeline.cast_params_for_inference(model)


def _reset_launches() -> None:
    from frankenstein_tpu_torch.ops.cuda import beam_reorder as k3
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    from frankenstein_tpu_torch.ops.cuda import fused_llama_decode as k5
    from frankenstein_tpu_torch.ops.cuda import fused_mlp as k9
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    k1.launches = k1.launches_bwd = k1.launches_int8 = 0
    k2.launches = k2.launches_int8_kv = k3.launches = 0
    k5.launches = k5.launches_int8_kv = k9.launches = k8.launches = 0


def _read_launches() -> dict:
    from frankenstein_tpu_torch.ops.cuda import beam_reorder as k3
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    from frankenstein_tpu_torch.ops.cuda import fused_llama_decode as k5
    from frankenstein_tpu_torch.ops.cuda import fused_mlp as k9
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    return {"K1": k1.launches, "K2": k2.launches,
            "K2-int8": k2.launches_int8_kv, "K3": k3.launches,
            "K4": k1.launches_bwd, "K5": k5.launches,
            "K5-int8": k5.launches_int8_kv, "K8": k8.launches,
            "K9": k9.launches, "K10": k1.launches_int8}


def _k9_blocks(cfg) -> int:
    """K9 launches per encode of a Franky or FrankyLlama: the encoder's
    blocks and each Perceiver layer's self-attention block (its
    cross-attention MLP is the module chain, as in the JAX package)."""
    return cfg.brain.encoder.n_layers + cfg.brain.n_layers


def _in_turns(fns: dict, repeats: int = 0) -> dict:
    """Each of ``fns`` (name -> thunk) called once to warm up, then timed one
    call at a time between CUDA events, in turns whose order flips every
    round: name -> {"ms": (median, min, max) over ``repeats``
    (TIMING_REPEATS) calls, "gib": the peak GiB of those calls}. Every on /
    off comparison of the phases is timed here."""
    import torch
    for fn in fns.values():
        fn()
    names = list(fns)
    ms, gib = {name: [] for name in fns}, dict.fromkeys(fns, 0.0)
    for i in range(repeats or TIMING_REPEATS):
        for name in (names if i % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end))
            gib[name] = max(gib[name],
                            torch.cuda.max_memory_allocated() / 2 ** 30)
    return {name: {"ms": _spread(ms[name]), "gib": gib[name]}
            for name in fns}


def _note(spread) -> str:
    return f"{spread[0]:.1f} ({spread[1]:.1f}-{spread[2]:.1f})"


def _k9_ab(fn) -> dict:
    """``fn()`` with K9 on and off (``fused_mlp.ENABLED``), in turns
    (``_in_turns``): {True: on, False: off}."""
    from frankenstein_tpu_torch.ops.cuda import fused_mlp as k9

    def setting(on):
        def call():
            k9.ENABLED = on
            return fn()
        return call

    try:
        return _in_turns({True: setting(True), False: setting(False)})
    finally:
        k9.ENABLED = True


def _ab_note(ab: dict) -> str:
    return (f"K9 on {_note(ab[True]['ms'])} ms (peak {ab[True]['gib']:.2f} "
            f"GiB), off {_note(ab[False]['ms'])} ms (peak "
            f"{ab[False]['gib']:.2f} GiB), medians (range) of "
            f"{TIMING_REPEATS}")


def phase_slice(card: str, model) -> dict:
    import torch
    from frankenstein_tpu_torch.config import GPT2_EOT
    from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
    from frankenstein_tpu_torch.decode import pipeline, sampling

    dev = torch.device("cuda")
    cfg = model.cfg
    enc = cfg.brain.encoder
    predict = pipeline.make_franky_predictor(model, ByteTokenizer(),
                                             int8_weights=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = torch.randn(8, enc.window_size, enc.n_electrodes, generator=gen,
                     device=dev)

    _reset_launches()
    out = predict(xs)
    torch.cuda.synchronize()
    launches = _read_launches()

    _check(len(out) == 8 and all(isinstance(s, str) for s in out),
           f"predictor returned {out!r}")
    _check(launches == {"K1": enc.n_layers, "K2": cfg.max_tokens,
                        "K2-int8": 0, "K3": 0, "K4": 0, "K5": 0,
                        "K5-int8": 0, "K8": 0, "K9": _k9_blocks(cfg),
                        "K10": 0},
           f"launches {launches}")
    prefix = model.encode(xs)
    idx0 = torch.full((8, 1), GPT2_EOT, dtype=torch.long, device=dev)
    cache = model.init_decode_cache(8, sampling._round_cache_len(
        1 + cfg.brain.n_output_tokens + cfg.max_tokens + 1))
    logits, _, _ = model.prefill(idx0, prefix, cache)
    _check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    toks = sampling.generate(model, idx0, prefix, gen, max_new_tokens=25,
                             top_k=10, qweights=sampling.quantize_serving_weights(model))
    _check(toks.shape == (8, 25) and int(toks.min()) >= 0
           and int(toks.max()) < cfg.gpt.vocab_size,
           f"token ids out of range: {toks.min()}..{toks.max()}")
    errs = _cpu_cross_check(model, xs)
    _check(max(errs.values()) <= SLICE_TOL, f"card vs CPU twins: {errs}")

    # batch-128 timings (the bench's headline batch)
    xb = torch.randn(128, enc.window_size, enc.n_electrodes, generator=gen,
                     device=dev)
    ab = _k9_ab(lambda: model.encode(xb))
    encode_ms = ab[True]["ms"][0]
    pb = model.encode(xb)
    idx_b = torch.full((128, 1), GPT2_EOT, dtype=torch.long, device=dev)
    qw = sampling.quantize_serving_weights(model)
    decode_ms = _time_ms(lambda: sampling.generate(
        model, idx_b, pb, gen, max_new_tokens=25, top_k=10, qweights=qw),
        iters=3, warmup=1)
    request_ms = _time_ms(lambda: predict(xs), iters=3, warmup=1)
    _profile_request(lambda: predict(xs), 4, "B=8 request, top-k 10, w8a16",
                     "K2", card)
    print(f"phase 4 slice: Franky flagship (768x256 window, 6144 tokens, "
          f"GPT-2 124M, bf16, w8a16 decode, top-k 10, 25 tokens): "
          f"{len(out)} strings, launches {launches} (K1 = {enc.n_layers} per "
          f"encode, K2 = {cfg.max_tokens} per request, K9 = "
          f"{_k9_blocks(cfg)} per encode), prefill logits "
          f"finite, token ids in [0, {cfg.gpt.vocab_size}), card vs f32 CPU "
          f"twins rel err prefix {errs['prefix']:.3e} logits "
          f"{errs['logits']:.3e} (tol {SLICE_TOL}) | B=128 encode "
          f"{encode_ms:.1f} ms, decode {decode_ms:.1f} ms | B=8 request "
          f"{request_ms:.1f} ms | B=128 encode {_ab_note(ab)} | {card}",
          flush=True)
    return {"launches": launches, "encode_ms_b128": encode_ms,
            "decode_ms_b128": decode_ms, "request_ms_b8": request_ms,
            "encode_ab": ab}


def phase_k3(card: str) -> dict:
    import torch
    from frankenstein_tpu_torch.ops.cuda import beam_reorder as k3
    w, bw, s = 5, 160, 64
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    # Franky's GPT-2 cache (12 layers, 768 lanes) in both dtypes, and
    # FrankyLlama's int8 cache (8 layers, E_kv = 512 lanes) of phase 11
    for key, mode, n_layer, e in (("bf16", "bf16", 12, 768),
                                  ("int8", "int8", 12, 768),
                                  ("int8-llama", "int8", 8, 512)):
        shape = (n_layer, bw, s, e)
        if mode == "int8":
            k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                                  dtype=torch.int8) for _ in range(2))
        else:
            k, v = (torch.randn(*shape, generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
        parent = torch.randint(0, w, (bw,), generator=gen, device=dev)
        want = [k3.beam_reorder_ref(c, parent, w=w) for c in (k, v)]
        k3.beam_reorder(k, v, parent, w=w)
        torch.cuda.synchronize()
        equal = torch.equal(k, want[0]) and torch.equal(v, want[1])
        ms = _time_ms(lambda: k3.beam_reorder(k, v, parent, w=w))
        plain_ms = _time_ms(lambda: [k3.beam_reorder_ref(c, parent, w=w)
                                     for c in (k, v)])
        flat = (torch.arange(bw, device=dev) // w) * w + parent
        library_ms = _time_ms(lambda: [c.index_select(1, flat)
                                       for c in (k, v)])
        moved = _nbytes(k, v)
        bound = _bound(2 * moved + _nbytes(parent), 0)
        print(f"phase 5 K3 beam_reorder {mode} [{n_layer}, {bw}, {s}, {e}] "
              f"w={w}, both sides: bitwise equal to twin {equal} | kernel "
              f"{ms:.4f} ms ({2 * moved / ms / 1e6:.0f} GB/s if every row "
              f"moved), plain {plain_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
              f"index_select on both sides {library_ms:.4f} ms | {card}",
              flush=True)
        _check(equal, f"K3 {mode} [{n_layer}, {bw}, {s}, {e}] differs from "
               f"its twin")
        results[key] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, **bound}
    return results


def _code_check(got, want, pre) -> dict:
    """Codes the kernel wrote ([L, B, E]) against the twin's: how many
    differ, the largest difference, and how many differ although the twin's
    pre-rounding value is more than CODE_WINDOW away from a .5 tie, in all
    layers and in layer 0 (where both sides start from the same x)."""
    diff = (got.int() - want.int()).abs()
    off = (diff > 0) & (((pre.abs() % 1.0) - 0.5).abs() > CODE_WINDOW)
    return {"differ": int((diff > 0).sum()), "max_diff": int(diff.max()),
            "off_tie": int(off.sum()), "off_tie_layer0": int(off[0].sum())}


def _exact_targets(n_layer: int, e: int, dev):
    """For the exact rounding checks: per-(layer, lane) values t on .5
    ties, off ties and past +-127, power-of-two scales [L, 1, E], and the
    codes clamp(round-half-to-even(t)) that a new row of t * scale (k) or
    -t * scale (v) must give."""
    import torch
    lane = torch.arange(e, device=dev)
    frac = torch.tensor([0.5, -0.5, 0.25, 0.0], device=dev)
    t = torch.stack([((lane * 7 + l * 13) % 301 - 150).float()
                     + frac[lane % 4] for l in range(n_layer)])     # [L, E]
    scale = torch.stack([torch.full((1, e), 2.0 ** -(3 + l % 3), device=dev)
                         for l in range(n_layer)])                  # [L, 1, E]
    return t, scale, torch.clamp(torch.round(t), -127, 127).to(torch.int8)


def _wrong_codes(fns, call, kc, vc, row: int, want) -> dict:
    """call(fn, k, v) for the kernel and its twin, each on its own copy of
    the int8 cache: how many codes of ``row`` differ from ``want`` (k) and
    ``-want`` (v), over all layers and both sides."""
    wrong = {}
    for name, fn in zip(("kernel", "twin"), fns):
        k, v = kc.clone(), vc.clone()
        call(fn, k, v)
        wrong[name] = int((k[:, :, row] != want[:, None]).sum()
                          + (v[:, :, row] != -want[:, None]).sum())
    return wrong


def _k2_int8_exact(x, st, kc, vc, length: int, n_head: int) -> dict:
    """The rounding rule where the new K/V are known exactly: with qkv_w = 0
    the new rows are the qkv bias, set to ``_exact_targets``' t * scale."""
    import torch
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    n_layer, _, _, e = kc.shape
    t, scale, want = _exact_targets(n_layer, e, x.device)
    st = dict(st, qkv_w=torch.zeros_like(st["qkv_w"]),
              qkv_b=st["qkv_b"].clone())
    st["qkv_b"][:, e:2 * e] = t * scale[:, 0]
    st["qkv_b"][:, 2 * e:] = -t * scale[:, 0]
    return _wrong_codes(
        (k2.fused_decode_blocks, k2.fused_decode_blocks_ref),
        lambda fn, k, v: fn(x, st, k, v, length, scale, scale,
                            n_head=n_head), kc, vc, length, want)


def phase_k2_int8(card: str) -> dict:
    import torch
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    length, n_head = 33, 12
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    results = {}
    for mode, w8 in (("bf16", False), ("w8a16", True)):
        for b in (160, 8):
            x, st, kf, vf = _k2_inputs(b, gen, w8)
            kc, ks = k2.quantize_cache_side(kf)
            vc, vs = k2.quantize_cache_side(vf)
            kc_k, vc_k = kc.clone(), vc.clone()
            kc_a, vc_a = kc.clone(), vc.clone()
            kc_r, vc_r = kc.clone(), vc.clone()
            xo, _, _ = k2.fused_decode_blocks(x, st, kc_k, vc_k, length, ks,
                                              vs, n_head=n_head)
            xa, _, _ = k2.fused_decode_blocks(x, st, kc_a, vc_a, length, ks,
                                              vs, n_head=n_head)
            rows = []
            xr, _, _ = k2.fused_decode_blocks_ref(
                x, st, kc_r, vc_r, length, ks, vs, n_head=n_head,
                new_rows=rows)
            torch.cuda.synchronize()
            scale = float(xr.float().abs().max())
            err_x = _max_err(xo, xr)
            codes = [_code_check(got[:, :, length], want[:, :, length],
                                 torch.stack([r[i] for r in rows]) / sc)
                     for i, (got, want, sc) in enumerate(
                         ((kc_k, kc_r, ks), (vc_k, vc_r, vs)))]
            others = [r for r in range(kc.shape[2]) if r != length]
            untouched = (torch.equal(kc_k[:, :, others], kc[:, :, others])
                         and torch.equal(vc_k[:, :, others],
                                         vc[:, :, others]))
            exact = _k2_int8_exact(x, st, kc, vc, length, n_head)
            bound = _decode_bound(x, st, k2.WEIGHT_KEYS, kc, length,
                                  (ks, vs))
            bitwise = (torch.equal(xo, xa) and torch.equal(kc_k, kc_a)
                       and torch.equal(vc_k, vc_a))
            run = lambda: k2.fused_decode_blocks(
                x, st, kc_k, vc_k, length, ks, vs, n_head=n_head)
            ms = _time_ms(run)
            plain_ms = _time_ms(lambda: k2.fused_decode_blocks_ref(
                x, st, kc_r, vc_r, length, ks, vs, n_head=n_head))
            note, launch = _decode_report(
                run, ms, bound,
                k2.launch_info(12, b, kc.shape[2], 768, n_head, w8, True),
                "gpt2_decode_step", split=w8)
            print(f"phase 6 K2 fused_decode_blocks int8 KV, {mode} weights, "
                  f"L=12 E=768 H=12 S=64 B={b} length={length}: x_out "
                  f"max_abs_err {err_x:.3e} (max|x| {scale:.3f}), tol "
                  f"{K2_TOL} x max | new-row codes vs twin k {codes[0]} v "
                  f"{codes[1]} (tie window {CODE_WINDOW}) | exact-row "
                  f"codes wrong {exact} | other rows untouched {untouched} "
                  f"| two launches bitwise equal {bitwise} | kernel "
                  f"{ms:.4f} ms a token, plain {plain_ms:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
                  f"{note} | {card}", flush=True)
            _check(bitwise, f"K2 int8 {mode} B={b} is not deterministic")
            _check(torch.isfinite(xo).all(), f"K2 int8 {mode} not finite")
            _check(err_x <= K2_TOL * scale,
                   f"K2 int8 {mode} B={b} disagrees with its twin: {err_x}")
            # the twin's f32 K/V drift from the kernel's through the bf16
            # chain (other summation orders), so a code may round the other
            # way; the rounding rule itself is held exactly by the exact rows
            _check(all(c["max_diff"] <= 1 for c in codes),
                   f"K2 int8 {mode} B={b} codes: {codes}")
            _check(exact == {"kernel": 0, "twin": 0},
                   f"K2 int8 {mode} B={b} exact-row codes: {exact}")
            _check(untouched, f"K2 int8 {mode} wrote outside row {length}")
            results[(mode, b)] = {"max_abs_err": err_x, "ms": ms,
                                  "plain_ms": plain_ms, "launch": launch,
                                  **bound}
    return results


def _int8_logit_drift(model, xs, qw, steps: int = 5) -> float:
    """Teacher-forced decode from one prefill, bf16 cache against its int8
    copy: the largest |logit difference| over the steps, relative to the
    bf16 logits' range (max - min)."""
    import torch
    from frankenstein_tpu_torch.config import GPT2_EOT
    from frankenstein_tpu_torch.models import gpt2
    b = xs.shape[0]
    prefix = model.encode(xs)
    idx0 = torch.full((b, 1), GPT2_EOT, dtype=torch.long, device=xs.device)
    logits, cache, length = model.prefill(idx0, prefix,
                                          model.init_decode_cache(b, 64))
    qcache = gpt2.quantize_cache(cache)
    q_logits, q_length = logits, length
    drift = 0.0
    for _ in range(steps):
        tok = torch.argmax(logits, dim=-1)
        logits, cache, length = model.decode_step(tok, cache, length, qw)
        q_logits, qcache, q_length = model.decode_step(tok, qcache, q_length,
                                                       qw)
        span = float(logits.max() - logits.min())
        drift = max(drift, _max_err(q_logits, logits) / span)
    return drift


def phase_beams(card: str, model) -> dict:
    import tempfile
    from pathlib import Path

    import torch
    from frankenstein_tpu_torch.config import GPT2_EOT
    from frankenstein_tpu_torch.data.datasets import BrainDataset
    from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
    from frankenstein_tpu_torch.decode import pipeline, sampling
    from frankenstein_tpu_torch.eval.evaluate import evaluate_franky_wer
    from frankenstein_tpu_torch.eval.submission import (create_string_file,
                                                        make_predictions)

    dev = torch.device("cuda")
    cfg = model.cfg
    enc = cfg.brain.encoder
    b, w, steps = 32, 5, cfg.max_tokens
    predict = pipeline.make_franky_predictor(
        model, ByteTokenizer(), beam_width=w, int8_kv=True,
        int8_weights=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    xs = torch.randn(b, enc.window_size, enc.n_electrodes, generator=gen,
                     device=dev)

    _reset_launches()
    out = predict(xs)
    torch.cuda.synchronize()
    launches = _read_launches()
    _check(len(out) == b and all(isinstance(s, str) for s in out),
           f"beam predictor returned {out!r}")
    _check(launches == {"K1": enc.n_layers, "K2": steps, "K2-int8": steps,
                        "K3": steps, "K4": 0, "K5": 0, "K5-int8": 0,
                        "K8": 0, "K9": _k9_blocks(cfg), "K10": 0},
           f"beam path launches {launches}")

    qw = sampling.quantize_serving_weights(model)
    prefix = model.encode(xs)
    idx0 = torch.full((b, 1), GPT2_EOT, dtype=torch.long, device=dev)
    kw = dict(max_new_tokens=steps, int8_kv=True, qweights=qw)
    beam1, _ = sampling.beam_search(model, idx0, prefix, beam_width=1, **kw)
    greedy = sampling.generate(model, idx0, prefix, greedy=True, **kw)
    _check(torch.equal(beam1, greedy), "beam width 1 differs from greedy")
    drift = _int8_logit_drift(model, xs, qw)
    _check(drift <= INT8_KV_TOL, f"int8-KV logit drift {drift}")

    ds = BrainDataset.synthetic(64, seed=SEED)
    wer, preds = evaluate_franky_wer(model, ds, ByteTokenizer(),
                                     batch_size=b, beam_width=w)
    _check(len(preds) == 64 and wer == wer and wer != float("inf"),
           f"WER {wer} over {len(preds)} predictions")
    with tempfile.TemporaryDirectory() as tmp:
        sub = create_string_file(Path(tmp) / "sub.txt",
                                 make_predictions(ds, predict, batch_size=b))
        lines = sub.read_text().splitlines()
    _check(len(lines) == 64, f"submission has {len(lines)} lines")

    encode_ms = _time_ms(lambda: model.encode(xs), iters=3, warmup=1)
    decode_ms = _time_ms(lambda: sampling.beam_search(
        model, idx0, prefix, beam_width=w, eos_id=GPT2_EOT,
        length_penalty=1.0, **kw), iters=3, warmup=1)
    request_ms = _time_ms(lambda: predict(xs), iters=3, warmup=1)
    _profile_request(lambda: predict(xs), 7,
                     "B=32 beams of 5, int8 KV, w8a16", "K2", card)
    print(f"phase 7 beams: Franky flagship, beam width {w}, int8 KV, w8a16, "
          f"{steps} tokens, B={b}: {len(out)} strings, launches {launches} "
          f"(K1 = {enc.n_layers} and K9 = {_k9_blocks(cfg)} per encode, K2 "
          f"and K3 = {steps} per request), beam width 1 == greedy, int8-KV "
          f"logit drift "
          f"{drift:.3e} of the range (tol {INT8_KV_TOL}), synthetic WER "
          f"{wer:.4f} over {len(preds)} trials, submission {len(lines)} "
          f"lines | B={b} encode {encode_ms:.1f} ms, beam decode "
          f"{decode_ms:.1f} ms, request {request_ms:.1f} ms | {card}",
          flush=True)
    return {"launches": launches, "encode_ms": encode_ms,
            "decode_ms": decode_ms, "request_ms": request_ms}


def _k4_inputs(b: int, gen, dout=None, p: int = 256):
    """Flagship encoder attention: bf16 q, k, v (and dout), K1's out, lse."""
    import torch
    from frankenstein_tpu_torch.ops import rope
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    t, h, d = 6144, 8, 32
    dev = torch.device("cuda")
    q, k, v = (torch.randn(b, t, h * d, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    if dout is None:
        dout = torch.randn(b, t, h * d, generator=gen,
                           device=dev).to(torch.bfloat16)
    cos, sin = rope.folded_tables(rope.build_rope_cache(d, t, device=dev),
                                  1)
    kw = dict(n_heads=h, tok_per_time=p)
    out, lse = k1.slab_rope_attention(q, k, v, cos, sin, **kw)
    return (q, k, v, cos, sin, out, lse, dout), kw


def _k4_checks(b: int, gen, p: int) -> dict:
    """K4 at the flagship shape with slabs of ``p`` tokens against its twin
    (dq, dk, dv relative to max |twin|), its pre-pass against the pre-pass
    twin (qr, kr bitwise, delta relative to max |twin|), the probability
    rows it recomputes (a one-hot dout makes column c of dv row i_c), and
    two launches bitwise equal. Raises where a check fails."""
    import torch
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    args, kw = _k4_inputs(b, gen, p=p)
    t, e = args[0].shape[1:]
    h = kw["n_heads"]
    d = e // h
    got = k1.slab_rope_attention_bwd(*args, **kw)
    again = k1.slab_rope_attention_bwd(*args, **kw)
    want = k1.slab_rope_attention_bwd_ref(*(x.float() for x in args), **kw)
    q, k, _, cos, sin, out, _, dout = args
    prep = k1.slab_rope_bwd_prep(q, k, cos, sin, out, dout, n_heads=h)
    prep_ref = k1.slab_rope_bwd_prep_ref(q, k, cos, sin, out, dout,
                                         n_heads=h)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(g, a) for g, a in zip(got, again))
    errs = [_max_err(g, w) for g, w in zip(got, want)]
    rels = [e / float(w.abs().max()) for e, w in zip(errs, want)]
    prep_bitwise = all(torch.equal(x, y) for x, y in zip(prep[:2],
                                                         prep_ref[:2]))
    delta_rel = _max_err(prep[2], prep_ref[2]) / float(
        prep_ref[2].abs().max())

    rows = torch.arange(d, device="cuda") * 191 % t
    onehot = torch.zeros(b, t, h * d, dtype=torch.bfloat16, device="cuda")
    for head in range(h):
        onehot[:, rows, head * d + torch.arange(d, device="cuda")] = 1.0
    pargs, _ = _k4_inputs(b, gen, dout=onehot, p=p)
    _, _, dv = k1.slab_rope_attention_bwd(*pargs, **kw)
    rowsum = float((dv.float().reshape(b, t, h, d).sum(dim=1) - 1.0)
                   .abs().max())
    where = f"K4 at P={p}"
    _check(all(bool(torch.isfinite(g).all()) for g in got),
           f"{where}: output not finite")
    _check(max(rels) <= K4_TOL, f"{where} disagrees with its twin: {rels}")
    _check(rowsum <= ROWSUM_TOL, f"{where}: probability rows off by "
           f"{rowsum}")
    _check(bitwise, f"{where} is not deterministic")
    _check(prep_bitwise, f"{where}: pre-pass qr / kr differ from the twin")
    _check(delta_rel <= 1e-6, f"{where}: pre-pass delta off by {delta_rel}")
    return {"args": args, "kw": kw, "got": got, "errs": errs, "rels": rels,
            "rowsum": rowsum, "bitwise": bitwise,
            "prep_bitwise": prep_bitwise, "delta_rel": delta_rel}


def phase_k4(card: str) -> dict:
    """K4 against its twins at the flagship shape, at P=256 (the unmasked
    instance) and P=96 (the masked one); then, at P=256, the kernel and
    SDPA's backward timed in turns (``_in_turns``) at B=2 and B=32, the
    kernel back to back at B=2, its bound, its exp floor (one ex2 a visible
    pair a pass at EXP2_PER_S), issued TFLOP/s (14·D ops a visible pair in
    the two passes) and registers and resident CTAs an SM of each pass."""
    import torch
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    b, t, h, d, p = 2, 6144, 8, 32, 256
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    main = _k4_checks(b, gen, p)
    masked = _k4_checks(b, gen, 96)
    args, kw, got = main["args"], main["kw"], main["got"]
    bwd = lambda a: (lambda: k1.slab_rope_attention_bwd(*a, **kw))
    sdpa = lambda a: _sdpa(*_sdpa_heads(*a[:5], h),
                           _slab_mask(t, p, a[0].device), a[-1])
    timed = _in_turns({"K4": bwd(args), "SDPA bwd": sdpa(args)})
    ms = _time_ms(bwd(args))
    plain_ms = _time_ms(lambda: k1.slab_rope_attention_bwd_ref(*args, **kw),
                        iters=3)
    pairs = h * b * _slab_pairs(t, p)
    # five products of D per visible (query, key) pair against K1's two
    bound = _bound(_nbytes(*args, *got), 10 * d * pairs)
    exp_floor = 2 * pairs / EXP2_PER_S * 1e3
    occ = {(pas, pp): k1.bwd_occupancy(pas, d, pp)
           for pp in (p, 96) for pas in k1.BWD_PASSES}
    bargs, _ = _k4_inputs(32, gen)
    big = _in_turns({"K4": bwd(bargs), "SDPA bwd": sdpa(bargs)})
    ms_b32 = big["K4"]["ms"][0]
    b2b_b32 = _time_ms(bwd(bargs), iters=5)
    passes = _by_kernel(bwd(bargs),
                        r"slab_rope_attn_bwd_(prep|dkv|dq)(?![a-z_])",
                        {"prep", "dq", "dkv"})
    del bargs
    print(f"phase 8 K4 slab_rope_attention_bwd B={b} T={t} E={h * d} H={h} "
          f"bf16 | P={p} (unmasked instance): dq/dk/dv rel err "
          f"{main['rels'][0]:.3e}/{main['rels'][1]:.3e}/"
          f"{main['rels'][2]:.3e} (tol {K4_TOL} x max|twin|), probability "
          f"rows sum to 1 within {main['rowsum']:.3e} (tol {ROWSUM_TOL}), "
          f"two launches bitwise equal {main['bitwise']}, pre-pass qr/kr "
          f"bitwise {main['prep_bitwise']}, delta rel err "
          f"{main['delta_rel']:.3e} | P=96 (masked instance): dq/dk/dv rel "
          f"err {masked['rels'][0]:.3e}/{masked['rels'][1]:.3e}/"
          f"{masked['rels'][2]:.3e}, rows within {masked['rowsum']:.3e}, "
          f"bitwise {masked['bitwise']}, pre-pass bitwise "
          f"{masked['prep_bitwise']}, delta {masked['delta_rel']:.3e} | "
          f"P={p} in turns, medians (range) of {TIMING_REPEATS}: kernel "
          f"{_ms_note(timed, 'K4')} ms, SDPA backward "
          f"{_ms_note(timed, 'SDPA bwd')} ms; back to back {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}), exp floor {exp_floor:.4f} ms, issued "
          f"{14 * d * pairs / ms / 1e9:.1f} TFLOP/s | registers / CTAs an "
          f"SM: " + ", ".join(f"{pas} P={pp} {r} / {c}" for (pas, pp), (r, c)
                              in occ.items()) +
          f" | B=32 in turns: kernel {_ms_note(big, 'K4')} ms, SDPA "
          f"backward {_ms_note(big, 'SDPA bwd')} ms; kernel back to back "
          f"{b2b_b32:.3f} ms, exp floor "
          f"{16 * exp_floor:.3f} ms; by pass (torch.profiler, ms a call) "
          + ", ".join(f"{pas} {ms_:.3f}" for pas, ms_ in passes.items()) +
          f" | {card}", flush=True)
    return {"max_abs_err": max(main["errs"]), "ms": ms, "plain_ms": plain_ms,
            "ms_b32": ms_b32, "library_ms": timed["SDPA bwd"]["ms"][0],
            **bound}


def _grad_errs(card: dict, cpu: dict, names) -> dict:
    """Relative error of the global gradient norm and of each of
    ``names``' gradients, card against CPU."""
    import torch
    norm = lambda g: float(torch.sqrt(sum((v.double() ** 2).sum()
                                          for v in g.values())))
    errs = {"global_norm": abs(norm(card) - norm(cpu)) / norm(cpu)}
    for n in names:
        errs[n] = float((card[n] - cpu[n]).norm() / cpu[n].norm())
    return errs


def _grad_check(state, tcfg, ds) -> dict:
    """One step's gradients of a Franky or FrankyLlama on the card (bf16
    compute) against the same weights as f32 on the CPU (the kernels'
    twins), at B=1: relative error of the global norm and of each encoder
    attention weight."""
    import torch
    from frankenstein_tpu_torch.train import trainer
    x, y, _ = ds[0]
    batch = (torch.from_numpy(x[None]), torch.from_numpy(y[None]))
    state.optimizer.zero_grad(set_to_none=True)
    trainer.loss_and_grads(state, tuple(a.cuda() for a in batch),
                           tcfg.replace(grad_accum=1, p_augs=0.0))
    ref = type(state.model)(state.model.cfg)     # Franky or FrankyLlama
    ref.load_state_dict({k: v.cpu() for k, v in
                         state.model.state_dict().items()})
    ref(*batch)[0].backward()
    card = {n: p.grad.cpu() for n, p in state.model.named_parameters()}
    cpu = {n: p.grad for n, p in ref.named_parameters()}
    state.optimizer.zero_grad(set_to_none=True)
    return _grad_errs(card, cpu, [
        n for n in cpu
        if n.startswith("brain_model.encoder.") and ".attn." in n])


def _batches(ds, batch_size: int, n: int) -> list:
    """n (x, y) training batches on the card."""
    import torch
    from frankenstein_tpu_torch.data.datasets import batch_iterator
    it = batch_iterator(ds, batch_size, shuffle=True, seed=SEED)
    return [tuple(torch.from_numpy(a).cuda() for a in next(it))[:2]
            for _ in range(n)]


def _time_steps(state, tcfg, ds, batch_size: int, steps: int):
    """(ms per step, peak GiB) of ``steps`` train steps after one warm-up."""
    import torch
    from frankenstein_tpu_torch.train import trainer
    from frankenstein_tpu_torch.train.schedule import make_lr_schedule
    batches = _batches(ds, batch_size, steps + 1)
    sched = make_lr_schedule(tcfg)
    gen = torch.Generator(device="cuda")
    trainer.train_step(state, batches[0], tcfg, sched, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in batches[1:]:
        trainer.train_step(state, batch, tcfg, sched, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000 / steps
    return ms, torch.cuda.max_memory_allocated() / 2 ** 30


def _train_stepper(state, tcfg, ds, batch_size: int):
    """A thunk that runs one train step on the next of four batches."""
    import itertools

    import torch
    from frankenstein_tpu_torch.train import trainer
    from frankenstein_tpu_torch.train.schedule import make_lr_schedule
    batches = itertools.cycle(_batches(ds, batch_size, 4))
    sched = make_lr_schedule(tcfg)
    gen = torch.Generator(device="cuda")
    return lambda: trainer.train_step(state, next(batches), tcfg, sched, gen)


def _family(name: str) -> str:
    for family, pattern in PROFILE_FAMILIES:
        if re.search(pattern, name, re.IGNORECASE):
            return family
    return "other"


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def _profile_request(fn, phase: int, what: str, kernel: str,
                     card: str) -> dict:
    """One request's device time by kernel family (torch.profiler, after
    a warm-up call); raises unless ``kernel``'s family ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    families: dict = {}
    for e in prof.key_averages():
        if _device_us(e) > 0 and not re.match(r"(Optimizer\.|ProfilerStep)",
                                               e.key):
            fam = _family(e.key)
            families[fam] = families.get(fam, 0.0) + _device_us(e) / 1e3
    fams = ", ".join(f"{fam} {ms:.2f}" for fam, ms in
                     sorted(families.items(), key=lambda kv: -kv[1]))
    print(f"phase {phase} profile {what} (torch.profiler, one request): "
          f"device time {sum(families.values()):.1f} ms | ms by family: "
          f"{fams} | {card}", flush=True)
    _check(families.get(kernel, 0.0) > 0,
           f"phase {phase}: no {kernel} kernel in the request's profile")
    return families


def _profile_steps(state, tcfg, ds, what: str, card: str,
                   batch_size: int = 32, phase: int = 13) -> dict:
    """Where a train step's device time goes (B=32 unless ``batch_size``
    says): torch.profiler over
    PROFILE_STEPS steps, the device time of every kernel summed by family
    (PROFILE_FAMILIES) and a step's top kernels, and the device's busy
    share of the window (summed kernel time over its wall time). Run after
    every timed phase, so the profiler's hooks touch no other number."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from frankenstein_tpu_torch.train import trainer
    from frankenstein_tpu_torch.train.schedule import make_lr_schedule
    batches = _batches(ds, batch_size, PROFILE_STEPS)
    sched = make_lr_schedule(tcfg)
    gen = torch.Generator(device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            trainer.train_step(state, batch, tcfg, sched, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, less the host's range annotations mirrored onto the
    # device timeline (``Optimizer.step#AdamW.step``), which overlap kernels
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and _device_us(e) > 0
               and not re.match(r"(Optimizer\.|ProfilerStep)", e.key)]
    per_step = lambda us: us / 1e3 / PROFILE_STEPS
    total = per_step(sum(_device_us(e) for e in kernels))
    families: dict = {}
    for e in kernels:
        fam = _family(e.key)
        families[fam] = families.get(fam, 0.0) + per_step(_device_us(e))
    fams = ", ".join(f"{fam} {ms:.2f}" for fam, ms in
                     sorted(families.items(), key=lambda kv: -kv[1]))
    top = ", ".join(f"{e.key[:48]} x{e.count // PROFILE_STEPS} "
                    f"{per_step(_device_us(e)):.2f}" for e in
                    sorted(kernels, key=_device_us,
                           reverse=True)[:PROFILE_TOP])
    print(f"phase {phase} profile {what} B={batch_size}, {PROFILE_STEPS} "
          f"steps (torch.profiler): {wall_ms / PROFILE_STEPS:.1f} ms a step "
          f"on the host clock, device time {total:.1f} ms a step, busy "
          f"{100 * total / max(wall_ms / PROFILE_STEPS, 1e-9):.1f}% | ms a "
          f"step by family: {fams} | top kernels (launches and ms a step): "
          f"{top} | {card}", flush=True)
    _check(total > 0, f"the profiler recorded no device time for {what}")
    return {"device_ms": total, "families": families}


def phase_train(card: str) -> dict:
    import tempfile
    from pathlib import Path

    import torch
    from frankenstein_tpu_torch import submit
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.train import __main__ as train_cli

    repo = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        _reset_launches()
        t0 = time.perf_counter()
        state = train_cli.main([
            "--config", str(repo / "configs" / "franky.yaml"),
            "--data", "synthetic", "--synthetic-trials", "256",
            "--steps", str(TRAIN_STEPS), "--batch-size", "32",
            "--warmup", "5", "--eval-interval", str(TRAIN_STEPS),
            "--exp-name", "smoke", "--save-folder", tmp])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _read_launches()
        run_dir = Path(tmp) / "smoke"
        losses, val, rate = _run_record(run_dir)
        cfg = state.model.cfg
        n_layers = cfg.brain.encoder.n_layers
        _check_run(state, losses, val, TRAIN_STEPS, "Franky")
        # one eval batch: 32 validation trials at batch 32
        _check(launches["K4"] == n_layers * TRAIN_STEPS
               and launches["K1"] == n_layers * (TRAIN_STEPS + 1)
               and launches["K9"] == _k9_blocks(cfg) * (TRAIN_STEPS + 1)
               and launches["K2"] == launches["K3"] == launches["K5"] == 0
               and launches["K8"] == launches["K10"] == 0,
               f"training launches {launches}")

        best = _restores_bitwise(state, run_dir, Franky(
            cfg, device=torch.device("cuda"), dtype=torch.bfloat16))
        tcfg = _train_config(run_dir)

        sub = submit.main(["--run-dir", str(run_dir), "--data", "synthetic",
                           "--synthetic-trials", "8", "--out",
                           str(Path(tmp) / "sub.txt")])
        lines = sub.read_text().splitlines()
        _check(len(lines) == 8, f"submission has {len(lines)} lines")

        ds = train_cli.build_datasets("synthetic", 768, 256, 256)[0]
        grad_errs = _grad_check(state, tcfg, ds)
        step_ms, peak = _time_steps(state, tcfg, ds, 32, 5)
        ab = _k9_ab(_train_stepper(state, tcfg, ds, 32))
        big = tcfg.replace(batch_size=256, grad_accum=8)
        big_ms, big_peak = _time_steps(state, big, ds, 256, 1)
    worst = max(grad_errs, key=grad_errs.get)
    print(f"phase 9 training: Franky flagship (768x256 window, 6144 tokens, "
          f"GPT-2 124M, f32 params, bf16 compute), {TRAIN_STEPS} steps at "
          f"B=32 through the train CLI in {run_s:.1f} s: train loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (logged {len(losses)}), val "
          f"{val[-1]:.4f}, samples/s in the log {rate[-1]:.1f}, launches "
          f"{launches} (K4 = {n_layers} per step, K1 = {n_layers} and K9 = "
          f"{_k9_blocks(cfg)} per forward), checkpoint {best} restored "
          f"bitwise, submit "
          f"--run-dir wrote {len(lines)} lines | B=1 card vs f32 CPU twin "
          f"gradients: global norm rel err {grad_errs['global_norm']:.3e}, "
          f"worst encoder attention weight {worst} {grad_errs[worst]:.3e} "
          f"(tol {GRAD_TOL}) | B=32 step {step_ms:.1f} ms, "
          f"{32e3 / step_ms:.1f} samples/s, peak {peak:.2f} GiB; in turns "
          f"{_ab_note(ab)} | B=256 grad_accum 8 step {big_ms:.1f} ms, peak "
          f"{big_peak:.2f} GiB | {card}", flush=True)
    _check(max(grad_errs.values()) <= GRAD_TOL,
           f"card vs CPU gradients: {grad_errs}")
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak,
            "big_ms": big_ms, "big_peak_gib": big_peak, "grad": grad_errs,
            "step_ab": ab}


def _train_config(run_dir):
    from frankenstein_tpu_torch.config import TrainConfig
    return TrainConfig.from_json((run_dir / "train_config.json").read_text())


def _k5_inputs(gen, n_layers, b, s, e, h, kv, f, w8: bool, int8: bool):
    """bf16 x and weights (w8a16 through ``quantize_weights``), f32 norms,
    a bf16 cache or its int8 codes with per-(layer, lane) scales."""
    import torch
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    from frankenstein_tpu_torch.ops.cuda import fused_llama_decode as k5
    dev = torch.device("cuda")
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    e_kv = kv * (e // h)
    st = {key: 1.0 + 0.1 * rnd(n_layers, e) for key in ("norm1_w",
                                                         "norm2_w")}
    for key, shape in (("wq", (e, e)), ("wk", (e, e_kv)), ("wv", (e, e_kv)),
                       ("wo", (e, e)), ("wg", (e, f)), ("wu", (e, f)),
                       ("wd", (f, e))):
        st[key] = (0.02 * rnd(n_layers, *shape)).to(torch.bfloat16)
    if w8:
        st = k5.quantize_weights(st)
    kf, vf = (rnd(n_layers, b, s, e_kv) for _ in range(2))
    if int8:
        (kc, ks), (vc, vs) = (k2.quantize_cache_side(c) for c in (kf, vf))
    else:
        kc, vc, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, \
            None
    return rnd(b, e).to(torch.bfloat16), st, kc, vc, ks, vs


def _k5_int8_exact(n_layers, b, s, e, h, kv, f) -> dict:
    """The rounding rule where the new K/V are known exactly: x = 1, unit
    norms and wo = wd = 0 keep every layer's normalised row at exactly 1,
    and with only row 0 of wk, wv nonzero the new k, v rows ARE that row
    (at length 0 the rotation is the identity), set to
    ``_exact_targets``' t * scale."""
    import torch
    from frankenstein_tpu_torch.ops import rope
    from frankenstein_tpu_torch.ops.cuda import fused_llama_decode as k5
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    _, st, kc, vc, _, _ = _k5_inputs(gen, n_layers, b, s, e, h, kv, f,
                                     False, True)
    t, scale, want = _exact_targets(n_layers, kc.shape[-1], dev)
    st = dict(st, norm1_w=torch.ones_like(st["norm1_w"]),
              norm2_w=torch.ones_like(st["norm2_w"]),
              wo=torch.zeros_like(st["wo"]), wd=torch.zeros_like(st["wd"]),
              wk=torch.zeros_like(st["wk"]), wv=torch.zeros_like(st["wv"]))
    st["wk"][:, 0] = (t * scale[:, 0]).to(torch.bfloat16)
    st["wv"][:, 0] = (-t * scale[:, 0]).to(torch.bfloat16)
    cos, sin = (a[:1] for a in rope.folded_tables(
        rope.build_rope_cache(e // h, s, device=dev), h))
    x = torch.ones(b, e, dtype=torch.bfloat16, device=dev)
    return _wrong_codes(
        (k5.fused_llama_decode_blocks, k5.fused_llama_decode_blocks_ref),
        lambda fn, k, v: fn(x, st, k, v, 0, cos, sin, scale, scale,
                            n_heads=h, n_kv_heads=kv, eps=1e-5),
        kc, vc, 0, want)


def phase_k5(card: str) -> dict:
    import torch
    from frankenstein_tpu_torch.ops import rope
    from frankenstein_tpu_torch.ops.cuda import fused_llama_decode as k5
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    fl = dict(n_layers=8, s=64, e=1024, h=16, kv=8, f=2816)
    big = dict(n_layers=16, s=48, e=2048, h=16, kv=8, f=5632)
    cases = [("FrankyLlama", fl, 160, 46, True, True),
             ("FrankyLlama", fl, 160, 46, False, True),
             ("FrankyLlama", fl, 32, 46, False, False),
             ("FrankyLlama", fl, 32, 46, True, False),
             ("1B-class", big, 8, 40, False, False),
             ("1B-class", big, 8, 40, True, False)]
    results = {}
    for shape, g, b, length, w8, int8 in cases:
        x, st, kc, vc, ks, vs = _k5_inputs(gen, g["n_layers"], b, g["s"],
                                           g["e"], g["h"], g["kv"], g["f"],
                                           w8, int8)
        cos_e, sin_e = rope.folded_tables(rope.build_rope_cache(
            g["e"] // g["h"], g["s"], device="cuda"), g["h"])
        kw = dict(n_heads=g["h"], n_kv_heads=g["kv"], eps=1e-5)
        row = lambda n: (cos_e[n:n + 1], sin_e[n:n + 1])

        def run(fn, k, v, n, **extra):
            return fn(x, st, k, v, n, *row(n), ks, vs, **kw, **extra)

        kc_k, vc_k, kc_a, vc_a = kc.clone(), vc.clone(), kc.clone(), \
            vc.clone()
        kc_r, vc_r = kc.clone(), vc.clone()
        xo, _, _ = run(k5.fused_llama_decode_blocks, kc_k, vc_k, length)
        xa, _, _ = run(k5.fused_llama_decode_blocks, kc_a, vc_a, length)
        rows = []
        xr, _, _ = run(k5.fused_llama_decode_blocks_ref, kc_r, vc_r, length,
                       new_rows=rows)
        torch.cuda.synchronize()
        bitwise = (torch.equal(xo, xa) and torch.equal(kc_k, kc_a)
                   and torch.equal(vc_k, vc_a))
        scale = float(xr.float().abs().max())
        err_x = _max_err(xo, xr)
        others = [r for r in range(g["s"]) if r != length]
        untouched = (torch.equal(kc_k[:, :, others], kc[:, :, others])
                     and torch.equal(vc_k[:, :, others], vc[:, :, others]))
        if int8:
            codes = [_code_check(got[:, :, length], want[:, :, length],
                                 torch.stack([r[i] for r in rows]) / sc)
                     for i, (got, want, sc) in enumerate(
                         ((kc_k, kc_r, ks), (vc_k, vc_r, vs)))]
            # deeper layers drift through the bf16 chain, so a code there may
            # round the other way; in layer 0 both sides start from the same
            # x, so every code off a tie must be the twin's
            rows_ok = all(c["max_diff"] <= 1 and c["off_tie_layer0"] == 0
                          for c in codes)
            row_note = f"new-row codes vs twin k {codes[0]} v {codes[1]}"
        else:
            err_row = max(_max_err(kc_k[:, :, length], kc_r[:, :, length]),
                          _max_err(vc_k[:, :, length], vc_r[:, :, length]))
            row_scale = float(kc_r[:, :, length].float().abs().max())
            rows_ok = err_row <= K5_TOL * row_scale
            row_note = (f"new-row max_abs_err {err_row:.3e} (max|row| "
                        f"{row_scale:.3f})")
        # three chained steps from length 7 write rows 7, 8 and 9
        chain = 0.0
        kc_k, vc_k, kc_r, vc_r = kc.clone(), vc.clone(), kc.clone(), \
            vc.clone()
        for n in (7, 8, 9):
            xo_n, _, _ = run(k5.fused_llama_decode_blocks, kc_k, vc_k, n)
            xr_n, _, _ = run(k5.fused_llama_decode_blocks_ref, kc_r, vc_r, n)
            chain = max(chain, _max_err(xo_n, xr_n)
                        / float(xr_n.float().abs().max()))
        bound = _decode_bound(x, st, k5.WEIGHT_KEYS, kc, length, (ks, vs))
        call = lambda: run(k5.fused_llama_decode_blocks, kc_a, vc_a, length)
        ms = _time_ms(call)
        note, launch = _decode_report(
            call, ms, bound,
            k5.launch_info(g["n_layers"], b, g["s"], g["e"], g["h"], g["kv"],
                           g["f"], w8, int8),
            "llama_decode_step", split=w8 and (b == 160 or b == 8))
        plain_ms = _time_ms(lambda: run(k5.fused_llama_decode_blocks_ref,
                                        kc_r, vc_r, length), iters=3)
        exact = (_k5_int8_exact(g["n_layers"], b, g["s"], g["e"], g["h"],
                                g["kv"], g["f"]) if int8 else None)
        mode = (f"{'w8a16' if w8 else 'bf16'} weights, "
                f"{'int8' if int8 else 'bf16'} cache")
        print(f"phase 10 K5 fused_llama_decode_blocks {shape} L="
              f"{g['n_layers']} E={g['e']} H={g['h']} KV={g['kv']} "
              f"F={g['f']} S={g['s']} B={b} length={length}, {mode}: x_out "
              f"max_abs_err {err_x:.3e} (max|x| {scale:.3f}), tol {K5_TOL} "
              f"x max | {row_note} | other rows untouched {untouched} | "
              f"3-step chain from length 7 rel err {chain:.3e} | two "
              f"launches bitwise equal {bitwise} | exact-row codes wrong "
              f"{exact} | kernel {ms:.4f} ms a token, plain {plain_ms:.4f} "
              f"ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
              f"{note} | {card}", flush=True)
        _check(torch.isfinite(xo).all(), f"K5 {shape} {mode} not finite")
        _check(err_x <= K5_TOL * scale and chain <= K5_TOL,
               f"K5 {shape} B={b} {mode} disagrees with its twin: x {err_x},"
               f" chain {chain}")
        _check(rows_ok, f"K5 {shape} B={b} {mode} new rows: {row_note}")
        _check(untouched, f"K5 {shape} {mode} wrote outside row {length}")
        _check(bitwise, f"K5 {shape} {mode} is not deterministic")
        _check(exact in (None, {"kernel": 0, "twin": 0}),
               f"K5 {shape} {mode} exact-row codes: {exact}")
        results[(shape, b, w8, int8)] = {"max_abs_err": err_x, "ms": ms,
                                         "plain_ms": plain_ms,
                                         "launch": launch, **bound}
        del x, st, kc, vc, kc_k, vc_k, kc_a, vc_a, kc_r, vc_r
    return results


def _franky_llama():
    """FrankyLlama at ``configs/franky_llama.yaml``'s model config on the
    card: random weights from SEED, bf16."""
    import torch
    import yaml
    from pathlib import Path
    from frankenstein_tpu_torch.config import FrankyLlamaConfig
    from frankenstein_tpu_torch.decode import pipeline
    from frankenstein_tpu_torch.models.franky import FrankyLlama
    from frankenstein_tpu_torch.models.weights import init_franky_llama_
    doc = yaml.safe_load((Path(__file__).resolve().parent / "configs"
                          / "franky_llama.yaml").read_text())
    cfg = FrankyLlamaConfig.from_dict(doc.get("model_config", {}))
    _check(cfg == FrankyLlamaConfig(), "franky_llama.yaml is not the "
           "FrankyLlamaConfig defaults")
    model = init_franky_llama_(FrankyLlama(cfg, device=torch.device("cuda")),
                               seed=SEED)
    return pipeline.cast_params_for_inference(model)


def phase_franky_llama(card: str, model) -> dict:
    import torch
    from frankenstein_tpu_torch.config import GPT2_EOT
    from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
    from frankenstein_tpu_torch.decode import pipeline, sampling
    from frankenstein_tpu_torch.models import llama

    dev = torch.device("cuda")
    cfg = model.cfg
    enc = cfg.brain.encoder
    b, w, steps = 32, 5, cfg.max_tokens
    predict = pipeline.make_franky_predictor(
        model, ByteTokenizer(), beam_width=w, int8_kv=True,
        int8_weights=True, rescorer=(model,))
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    xs = torch.randn(b, enc.window_size, enc.n_electrodes, generator=gen,
                     device=dev)

    _reset_launches()
    out = predict(xs)
    torch.cuda.synchronize()
    launches = _read_launches()
    _check(len(out) == b and all(isinstance(t, str) for t in out),
           f"FrankyLlama predictor returned {out!r}")
    _check(launches == {"K1": enc.n_layers, "K2": 0, "K2-int8": 0,
                        "K3": steps, "K4": 0, "K5": steps,
                        "K5-int8": steps, "K8": 0, "K9": _k9_blocks(cfg),
                        "K10": 0},
           f"FrankyLlama beam path launches {launches}")

    qw = sampling.quantize_serving_weights(model)
    prefix = model.encode(xs)
    idx0 = torch.full((b, 1), GPT2_EOT, dtype=torch.long, device=dev)
    kw = dict(max_new_tokens=steps, int8_kv=True, qweights=qw)
    beam = lambda p: sampling.beam_search(
        model, idx0, p, beam_width=w, eos_id=GPT2_EOT, length_penalty=1.0,
        n_best=True, **kw)
    rescore = lambda t, sc: llama.rescore_candidates(
        model, llama.candidates_from_beams(t, GPT2_EOT), decoder_scores=sc)
    best, _ = rescore(*beam(prefix))
    moved = int((best != 0).sum())
    beam1, _ = sampling.beam_search(model, idx0, prefix, beam_width=1, **kw)
    greedy = sampling.generate(model, idx0, prefix, greedy=True, **kw)
    _check(torch.equal(beam1, greedy), "beam width 1 differs from greedy")
    drift = _int8_logit_drift(model, xs, qw)
    _check(drift <= INT8_KV_TOL, f"int8-KV logit drift {drift}")
    errs = _cpu_cross_check(model, xs)
    _check(max(errs.values()) <= SLICE_TOL, f"card vs CPU twins: {errs}")

    topk = pipeline.make_franky_predictor(model, ByteTokenizer(),
                                          int8_weights=True)
    _reset_launches()
    top_out = topk(xs)
    torch.cuda.synchronize()
    top_launches = _read_launches()
    _check(len(top_out) == b and top_launches["K5"] == steps
           and top_launches["K5-int8"] == 0 and top_launches["K3"] == 0
           and top_launches["K9"] == _k9_blocks(cfg),
           f"FrankyLlama top-k path: {len(top_out)} strings, launches "
           f"{top_launches}")

    def stages():
        """One request's chain, stage by stage: encode, beams, rescore."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        p = model.encode(xs)
        ev[1].record()
        t, sc = beam(p)
        ev[2].record()
        rescore(t, sc)
        ev[3].record()
        ev[3].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    stages()
    staged = list(zip(*(stages() for _ in range(TIMING_REPEATS))))
    encode_ms, decode_ms, rescore_ms = (_spread(s) for s in staged)
    request_ms = _spread(_time_each_ms(lambda: predict(xs)))
    _profile_request(lambda: predict(xs), 11, "FrankyLlama B=32 beams of 5, "
                     "int8 KV, w8a16, rescored", "K5", card)
    topk_ms = _spread(_time_each_ms(lambda: topk(xs)))
    fmt = lambda s: f"{s[0]:.1f} [{s[1]:.1f}, {s[2]:.1f}]"
    print(f"phase 11 FrankyLlama: {enc.window_size}x{enc.n_electrodes} "
          f"window, {enc.n_layers}-layer encoder of width {enc.dim}, "
          f"{cfg.brain.n_layers}-layer Perceiver to {cfg.brain.n_output_tokens}"
          f"x{cfg.brain.output_dim}, LLaMA "
          f"L={cfg.lm.n_layers} E={cfg.lm.dim} H={cfg.lm.n_heads} "
          f"KV={cfg.lm.n_kv_heads} F={cfg.lm.hidden_dim} V="
          f"{cfg.lm.vocab_size}, bf16, beams of {w}, int8 KV, w8a16, "
          f"{steps} tokens, n-best LLaMA rescoring, B={b}: {len(out)} "
          f"strings, launches {launches} (K1 = {enc.n_layers} and K9 = "
          f"{_k9_blocks(cfg)} per encode, K5 int8-KV and K3 = {steps} per "
          f"request), rescorer moved "
          f"{moved} of {b} rows off the first beam, beam width 1 == greedy, "
          f"int8-KV logit drift {drift:.3e} of the range (tol "
          f"{INT8_KV_TOL}), card vs f32 CPU twins rel err prefix "
          f"{errs['prefix']:.3e} logits {errs['logits']:.3e} (tol "
          f"{SLICE_TOL}), top-k path {len(top_out)} strings with launches "
          f"{top_launches} | B={b}, median [min, max] of "
          f"{TIMING_REPEATS} runs: within one chain encode "
          f"{fmt(encode_ms)} ms, beam decode {fmt(decode_ms)} ms, rescore "
          f"{fmt(rescore_ms)} ms (medians sum to "
          f"{encode_ms[0] + decode_ms[0] + rescore_ms[0]:.1f} ms); request "
          f"{fmt(request_ms)} ms ({b * 1e3 / request_ms[0]:.1f} sentences/s "
          f"at the median), top-k request {fmt(topk_ms)} ms | {card}",
          flush=True)
    return {"launches": launches, "top_launches": top_launches,
            "encode_ms": encode_ms, "decode_ms": decode_ms,
            "rescore_ms": rescore_ms, "request_ms": request_ms,
            "topk_ms": topk_ms, "moved": moved}


def _flash_inputs(mode: str, b: int, gen, dout=None):
    """bf16 q, k, v, dout [B, T, 256] and the wrapper's keywords: K6 over
    the 1536 tokens ``masking_indices`` keeps of 6144, with their slab ids;
    K7 dense or slab-causal over all 6144."""
    import torch
    from frankenstein_tpu_torch.models.brainformer import masking_indices
    h, d, p, n_full = 8, 32, 256, 6144
    dev = torch.device("cuda")
    sid = None
    t = n_full
    if mode == "positions":
        _, kept = masking_indices(gen, b, n_full, 0.75)
        sid = (kept // p).to(torch.int32).contiguous()
        t = kept.shape[1]
    q, k, v = (torch.randn(b, t, h * d, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    if dout is None:
        dout = torch.randn(b, t, h * d, generator=gen,
                           device=dev).to(torch.bfloat16)
    kw = dict(n_heads=h, mode=mode, tok_per_time=p if mode == "slab" else 0,
              slab_ids=sid)
    return (q, k, v, dout), kw


def _flash_pairs(kw: dict, b: int, t: int) -> int:
    """Visible (query, key) pairs over the batch: the work these inputs
    need."""
    if kw["mode"] == "dense":
        return b * t * t
    if kw["mode"] == "slab":
        return b * _slab_pairs(t, kw["tok_per_time"])
    sid = kw["slab_ids"]
    return int((sid[:, None, :] <= sid[:, :, None]).sum())


def _flash_mask(kw: dict, t: int, dev):
    """The bool mask of a K6 / K7 mode for SDPA: None for dense, the slab
    mask, or [B, 1, N, N] from the slab ids."""
    if kw["mode"] == "slab":
        return _slab_mask(t, kw["tok_per_time"], dev)
    if kw["mode"] == "positions":
        sid = kw["slab_ids"]
        return (sid[:, None, :] <= sid[:, :, None])[:, None]
    return None


def _sdpa_backends(qkv, dout) -> dict:
    """The SDPA backward thunk of each backend that takes [B, H, T, D]
    ``qkv`` unmasked (its forward run under that backend), by name."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    thunks = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                thunk = _sdpa(*qkv, None, dout)
            thunk()
        except (AttributeError, RuntimeError):
            continue
        thunks[f"SDPA {name.split('_')[0].lower()} bwd"] = thunk
    return thunks


def _ms_note(timed: dict, name: str) -> str:
    med, lo, hi = timed[name]["ms"]
    return f"{med:.3f} ({lo:.3f}-{hi:.3f})"


def phase_flash(card: str) -> dict:
    """K6 and K7 (modes positions, dense, slab) forward and backward at the
    MAE's shapes against their twins; kernel and SDPA timed in turns
    (``_in_turns``) at B=2 and B=32 (SDPA with K6's bool mask, K7 dense
    unmasked; K7 slab's kernel alone), and the kernels back to
    back at B=2 (a single B=2 call also times the host's launch work);
    each mode's exp floor (one ex2 a visible pair a pass at EXP2_PER_S),
    issued TFLOP/s (4·D ops a pair forward, 14·D in the two backward
    passes) and registers and resident CTAs an SM of each pass."""
    import torch
    from frankenstein_tpu_torch.ops.cuda import flash_attention as k67
    b = 2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    results = {}
    for mode, name in (("positions", "K6"), ("dense", "K7"),
                       ("slab", "K7 slab")):
        (q, k, v, dout), kw = _flash_inputs(mode, b, gen)
        t, e = q.shape[1], q.shape[2]
        h, d = kw["n_heads"], e // kw["n_heads"]
        out, lse = k67.flash_attention(q, k, v, **kw)
        got = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        again = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        ref, ref_lse = k67.flash_attention_ref(q.float(), k.float(),
                                               v.float(), **kw)
        want = k67.flash_attention_bwd_ref(
            *(x.float() for x in (q, k, v, out)), lse, dout.float(), **kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(g, a) for g, a in zip(got, again))
        rel = lambda g, w: _max_err(g, w) / float(w.abs().max())
        fwd_rels = [rel(out, ref), rel(lse, ref_lse)]
        bwd_rels = [rel(g, w) for g, w in zip(got, want)]

        # dout one-hot on (query i_c, lane c) of every head: column c of dv
        # is row i_c of the probabilities the backward recomputes
        rows = torch.arange(d, device="cuda") * 191 % t
        onehot = torch.zeros_like(dout)
        for head in range(h):
            onehot[:, rows, head * d + torch.arange(d, device="cuda")] = 1.0
        _, _, dv = k67.flash_attention_bwd(q, k, v, out, lse, onehot, **kw)
        rowsum = float((dv.float().reshape(b, t, h, d).sum(dim=1) - 1.0)
                       .abs().max())

        qkv, mask = [_heads(x, h) for x in (q, k, v)], _flash_mask(kw, t,
                                                                  q.device)
        thunks = {
            "fwd": lambda: k67.flash_attention(q, k, v, **kw),
            "SDPA fwd": _sdpa(*qkv, mask),
            "bwd": lambda: k67.flash_attention_bwd(q, k, v, out, lse, dout,
                                                   **kw),
            "SDPA bwd": _sdpa(*qkv, mask, dout)}
        if mode == "dense":
            thunks.update(_sdpa_backends(qkv, dout))
        timed = _in_turns(thunks)
        fwd_ms, bwd_ms = timed["fwd"]["ms"][0], timed["bwd"]["ms"][0]
        fwd_lib = timed["SDPA fwd"]["ms"][0]
        bwd_lib = timed["SDPA bwd"]["ms"][0]
        backends = ", ".join(f"{key[5:]} {_ms_note(timed, key)}"
                             for key in timed if key.startswith("SDPA ")
                             and key not in ("SDPA fwd", "SDPA bwd"))
        fwd_b2b = _time_ms(thunks["fwd"])   # back to back: no host gaps
        bwd_b2b = _time_ms(thunks["bwd"])
        fwd_lib_b2b = _time_ms(thunks["SDPA fwd"])
        bwd_lib_b2b = _time_ms(thunks["SDPA bwd"])
        fwd_plain = _time_ms(lambda: k67.flash_attention_ref(q, k, v, **kw),
                             iters=3)
        bwd_plain = _time_ms(lambda: k67.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, **kw), iters=3)
        pairs = _flash_pairs(kw, b, t)
        sid = kw["slab_ids"]
        fwd_bound = _bound(_nbytes(q, k, v, sid, out, lse), 4 * d * h * pairs)
        bwd_bound = _bound(_nbytes(q, k, v, sid, out, lse, dout, *got),
                           10 * d * h * pairs)
        exp_fwd = h * pairs / EXP2_PER_S * 1e3
        occ = {pas: k67.occupancy(mode, pas, d) for pas in k67.PASSES}
        b32 = {}
        (qb, kb, vb, db), kwb = _flash_inputs(mode, 32, gen)
        ob, lb = k67.flash_attention(qb, kb, vb, **kwb)
        big = {"fwd": lambda: k67.flash_attention(qb, kb, vb, **kwb),
               "bwd": lambda: k67.flash_attention_bwd(qb, kb, vb, ob, lb, db,
                                                      **kwb)}
        if mode != "slab":   # K6 with its bool mask, K7 dense unmasked
            qkvb = [_heads(x, h) for x in (qb, kb, vb)]
            maskb = _flash_mask(kwb, t, qb.device)
            big.update({"SDPA fwd": _sdpa(*qkvb, maskb),
                        "SDPA bwd": _sdpa(*qkvb, maskb, db)})
        b32 = _in_turns(big)
        fwd_b32, bwd_b32 = b32["fwd"]["ms"][0], b32["bwd"]["ms"][0]
        pairs32 = _flash_pairs(kwb, 32, t)
        del qb, kb, vb, db, ob, lb, big
        sdpa32 = (f", SDPA forward {_ms_note(b32, 'SDPA fwd')}, backward "
                  f"{_ms_note(b32, 'SDPA bwd')}" if mode != "slab" else "")
        print(f"phase 12 {name} flash_attention mode={mode} B={b} T={t} "
              f"E={e} H={h}{' P=256' if mode != 'dense' else ''} bf16, "
              f"{pairs} visible pairs: out/lse rel err {fwd_rels[0]:.3e}/"
              f"{fwd_rels[1]:.3e}, dq/dk/dv rel err {bwd_rels[0]:.3e}/"
              f"{bwd_rels[1]:.3e}/{bwd_rels[2]:.3e} (tol {FLASH_TOL} x "
              f"max|twin|), probability rows sum to 1 within {rowsum:.3e} "
              f"(tol {ROWSUM_TOL}), two backward launches bitwise equal "
              f"{bitwise} | in turns, medians (range) of {TIMING_REPEATS}: "
              f"forward kernel {_ms_note(timed, 'fwd')} ms, SDPA "
              f"{_ms_note(timed, 'SDPA fwd')}; backward kernel "
              f"{_ms_note(timed, 'bwd')} ms, SDPA "
              f"{_ms_note(timed, 'SDPA bwd')}"
              f"{' (' + backends + ')' if backends else ''}; back to back "
              f"(10 calls) forward {fwd_b2b:.3f} ms (SDPA {fwd_lib_b2b:.3f}),"
              f" backward {bwd_b2b:.3f} ms (SDPA {bwd_lib_b2b:.3f}) | "
              f"forward: plain "
              f"{fwd_plain:.3f} ms, bound {fwd_bound['bound_ms']:.4f} ms "
              f"({fwd_bound['bound_by']}), exp floor {exp_fwd:.4f} ms, issued "
              f"{4 * d * h * pairs / fwd_ms / 1e9:.1f} TFLOP/s | backward: "
              f"plain {bwd_plain:.3f} ms, bound {bwd_bound['bound_ms']:.4f} "
              f"ms ({bwd_bound['bound_by']}), exp floor {2 * exp_fwd:.4f} ms, "
              f"issued {14 * d * h * pairs / bwd_ms / 1e9:.1f} TFLOP/s | "
              f"registers / CTAs an SM: " + ", ".join(
                  f"{pas} {r} / {c}" for pas, (r, c) in occ.items()) +
              f" | B=32 in turns: forward {_ms_note(b32, 'fwd')} ms (exp "
              f"floor {h * pairs32 / EXP2_PER_S * 1e3:.3f}), backward "
              f"{_ms_note(b32, 'bwd')} ms{sdpa32} | {card}", flush=True)
        _check(all(bool(torch.isfinite(x).all()) for x in (out, lse, *got)),
               f"{name} output not finite")
        _check(max(fwd_rels + bwd_rels) <= FLASH_TOL,
               f"{name} disagrees with its twin: {fwd_rels} {bwd_rels}")
        _check(rowsum <= ROWSUM_TOL, f"{name} probability rows off by "
               f"{rowsum}")
        _check(bitwise, f"{name} backward is not deterministic")
        # the kernels line's ms back to back, as every other entry's; the
        # medians in turns beside them
        results[mode] = (
            {"max_abs_err": max(_max_err(out, ref), _max_err(lse, ref_lse)),
             "ms": fwd_b2b, "plain_ms": fwd_plain, "library_ms": fwd_lib_b2b,
             "ms_in_turns": fwd_ms, "library_ms_in_turns": fwd_lib,
             "ms_b32": fwd_b32, **fwd_bound},
            {"max_abs_err": max(_max_err(g, w) for g, w in zip(got, want)),
             "ms": bwd_b2b, "plain_ms": bwd_plain, "library_ms": bwd_lib_b2b,
             "ms_in_turns": bwd_ms, "library_ms_in_turns": bwd_lib,
             "ms_b32": bwd_b32, **bwd_bound})
        del q, k, v, dout, out, lse, got, again, ref, want, onehot, thunks
    _slab_instances(gen, card)
    return results


def _slab_instances(gen, card: str) -> None:
    """K7 slab's wgmma passes (mode slab of ``csrc/flash_attention_dense.cu``)
    at P = 256 (the unmasked instance), 96 and 8 (the MASKED one: slab
    boundaries inside the 64-row groups, and a P below one tile), head_dim
    32 and 64, forward and backward against the twins, two backward
    launches bitwise equal; and each pass's registers and CTAs an SM, both
    instances."""
    import torch
    from frankenstein_tpu_torch.ops.cuda import flash_attention as k67
    b, t, h = 1, 1536, 4
    for d in (32, 64):
        for p in (256, 96, 8):
            q, k, v, dout = (torch.randn(b, t, h * d, generator=gen,
                                         device="cuda").to(torch.bfloat16)
                             for _ in range(4))
            kw = dict(n_heads=h, mode="slab", tok_per_time=p)
            out, lse = k67.flash_attention(q, k, v, **kw)
            got = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            again = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            ref, ref_lse = k67.flash_attention_ref(q.float(), k.float(),
                                                   v.float(), **kw)
            want = k67.flash_attention_bwd_ref(
                *(x.float() for x in (q, k, v, out)), lse, dout.float(), **kw)
            torch.cuda.synchronize()
            rel = lambda g, w: _max_err(g, w) / float(w.abs().max())
            rels = [rel(out, ref), rel(lse, ref_lse)] + [
                rel(g, w) for g, w in zip(got, want)]
            bitwise = all(torch.equal(g, a) for g, a in zip(got, again))
            masked = {pas: k67.slab_masked(p, pas, d) for pas in k67.PASSES}
            print(f"phase 12 K7 slab B={b} T={t} H={h} D={d} P={p}: out/lse "
                  f"and dq/dk/dv rel err " + "/".join(f"{x:.2e}" for x in rels)
                  + f" (tol {FLASH_TOL} x max|twin|), two backward launches "
                  f"bitwise equal {bitwise}, masked instance "
                  + ", ".join(f"{pas} {m}" for pas, m in masked.items())
                  + f" | {card}", flush=True)
            _check(all(bool(torch.isfinite(x).all())
                       for x in (out, lse, *got)), f"K7 slab P={p} D={d} "
                   f"not finite")
            _check(max(rels) <= FLASH_TOL, f"K7 slab P={p} D={d} disagrees "
                   f"with its twin: {rels}")
            _check(bitwise, f"K7 slab P={p} D={d} backward not deterministic")
            del q, k, v, dout, out, lse, got, again, ref, want
    occ = {(pas, d, m): k67.occupancy("slab", pas, d, m)
           for pas in k67.PASSES for d in (32, 64) for m in (False, True)}
    print("phase 12 K7 slab registers / CTAs an SM (pass, D, instance): "
          + ", ".join(f"{pas} D={d} {'masked' if m else 'unmasked'} "
                      f"{r} / {c}" for (pas, d, m), (r, c) in occ.items())
          + f" | {card}", flush=True)


def _read_flash() -> dict:
    from frankenstein_tpu_torch.ops.cuda import flash_attention as k67
    return {"K6": k67.launches["positions"],
            "K6-bwd": k67.launches_bwd["positions"],
            "K7": k67.launches["dense"], "K7-bwd": k67.launches_bwd["dense"],
            "K7-slab": k67.launches["slab"],
            "K7-slab-bwd": k67.launches_bwd["slab"]}


def _reset_flash() -> None:
    from frankenstein_tpu_torch.ops.cuda import flash_attention as k67
    for counts in (k67.launches, k67.launches_bwd):
        for mode in counts:
            counts[mode] = 0


class _CountCalls:
    """Counts the calls of the named module functions while installed: the
    plain twins and the plain attention path, which the card's main path
    must never run."""

    def __init__(self, targets):
        self.targets, self.calls, self.saved = targets, {}, []

    def __enter__(self):
        for mod, name in self.targets:
            real = getattr(mod, name)
            key = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"
            self.calls[key] = 0

            def counted(*a, _real=real, _key=key, **kw):
                self.calls[_key] += 1
                return _real(*a, **kw)

            self.saved.append((mod, name, real))
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def _mae_grad_check(model, ds, witness: bool = False) -> dict:
    """One step's gradients on the card (bf16 compute) against the same
    weights as f32 on the CPU (the twins), at B=1 with the same mask
    indices: ``errs``, the relative error of the global norm and of each
    attention weight (encoder and decoder). ``kernel_rel``: that step's
    K6 / K7 backward launches held to their f32 twins on the exact tensors
    they were given, the largest error relative to max |twin|. With
    ``witness``, ``witness``: the same weights' gradients from bf16 compute
    on the CPU (the twins, at the kernels' rounding points) against f32,
    what bf16 rounding alone gives each weight. ``s``: the seconds it
    took."""
    import torch
    from frankenstein_tpu_torch.models.brainformer import (MAE,
                                                           masking_indices)
    from frankenstein_tpu_torch.ops.cuda import flash_attention as k67
    t0 = time.perf_counter()
    cfg = model.cfg
    x = torch.from_numpy(ds[0][0][None])
    idx = masking_indices(torch.Generator().manual_seed(SEED), 1,
                          cfg.block_size, cfg.masking_ratio)
    model.zero_grad(set_to_none=True)
    seen, real_bwd = [], k67.flash_attention_bwd

    def keep(*a, **kw):
        seen.append((a, kw))
        return real_bwd(*a, **kw)

    k67.flash_attention_bwd = keep
    try:
        model(x.cuda().to(torch.bfloat16),
              indices=tuple(i.cuda() for i in idx))[0].backward()
    finally:
        k67.flash_attention_bwd = real_bwd
    with torch.no_grad():
        kernel_rel = max(
            _max_err(g, w) / float(w.abs().max()) for a, kw in seen
            for g, w in zip(real_bwd(*a, **kw), k67.flash_attention_bwd_ref(
                *(t.float() for t in a), **kw)))
    weights = {k: v.cpu() for k, v in model.state_dict().items()}
    card = {n: p.grad.cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)

    def cpu_grads(dtype):
        ref = MAE(cfg, dtype=dtype)
        ref.load_state_dict(weights)
        ref(x.to(dtype or torch.float32), indices=idx)[0].backward()
        return {n: p.grad for n, p in ref.named_parameters()}

    cpu = cpu_grads(None)
    attn = [n for n in cpu if ".attn." in n]
    out = {"errs": _grad_errs(card, cpu, attn), "kernel_rel": kernel_rel,
           "witness": {}}
    if witness:
        low = _grad_errs(cpu_grads(torch.bfloat16), cpu, attn)
        out["witness"] = {n: low[n] for n in attn}
    out["s"] = time.perf_counter() - t0
    return out


def phase_mae(card: str) -> dict:
    import tempfile
    from pathlib import Path

    import torch
    from frankenstein_tpu_torch.models.brainformer import MAE
    from frankenstein_tpu_torch.models.weights import init_mae_
    from frankenstein_tpu_torch.ops import attention as tattn
    from frankenstein_tpu_torch.ops.cuda import flash_attention as k67
    from frankenstein_tpu_torch.ops.cuda import fused_mlp as k9
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    from frankenstein_tpu_torch.train import __main__ as train_cli
    from frankenstein_tpu_torch.train import checkpoints as ckpt_lib
    from frankenstein_tpu_torch.train import trainer

    repo = Path(__file__).resolve().parent
    plain = [(k67, "flash_attention_ref"), (k67, "flash_attention_bwd_ref"),
             (k1, "slab_rope_attention_ref"),
             (k1, "slab_rope_attention_bwd_ref"),
             (k9, "fused_norm_swiglu_ref"), (tattn, "_softmax_av")]
    with tempfile.TemporaryDirectory() as tmp:
        _reset_launches()
        _reset_flash()
        t0 = time.perf_counter()
        with _CountCalls(plain) as twins:
            state = train_cli.main([
                "--config", str(repo / "configs" / "mae.yaml"),
                "--data", "synthetic", "--synthetic-trials", "256",
                "--steps", str(TRAIN_STEPS), "--batch-size", "32",
                "--warmup", "5", "--eval-interval", str(TRAIN_STEPS),
                "--exp-name", "mae", "--save-folder", tmp])
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, flash = _read_launches(), _read_flash()
        run_dir = Path(tmp) / "mae"
        losses, val, rate = _run_record(run_dir)
        cfg = state.model.cfg
        doc = json.loads((run_dir / "model_config.json").read_text())
        _check(doc["model"] == "mae", f"model_config.json says {doc}")
        _check_run(state, losses, val, TRAIN_STEPS, "the MAE")
        # one eval batch: 32 validation trials at batch 32
        passes = TRAIN_STEPS + 1
        want = {"K6": cfg.n_layers * passes, "K6-bwd": cfg.n_layers *
                TRAIN_STEPS, "K7": cfg.n_dec_layers * passes,
                "K7-bwd": cfg.n_dec_layers * TRAIN_STEPS, "K7-slab": 0,
                "K7-slab-bwd": 0}
        _check(flash == want, f"MAE launches {flash}, want {want}")
        k9_want = cfg.n_layers * passes     # the encoder's blocks only
        _check(launches.pop("K9") == k9_want,
               f"K9 launched {k9.launches} times, want {k9_want}")
        _check(not any(launches.values()),
               f"K1-K5, K8 or K10 launched: {launches}")
        _check(not any(twins.calls.values()),
               f"plain twins ran on the card: {twins.calls}")

        _keep_mae_run(ckpt_lib.best_checkpoint(run_dir))
        fresh = MAE(cfg, device=torch.device("cuda"), dtype=torch.bfloat16)
        best = _restores_bitwise(state, run_dir, fresh)
        tcfg = _train_config(run_dir)
        mae_encoder = {k: v.clone() for k, v in
                       fresh.encoder.state_dict().items()}
        del fresh

        ds = train_cli.build_datasets("synthetic", cfg.window_size,
                                      cfg.n_electrodes, 256)[0]
        xs = torch.from_numpy(ds[0][0][None].repeat(2, 0)).cuda()
        with torch.no_grad():
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            loss_p, recon, binary = state.model(
                xs.to(torch.bfloat16), generator=gen, return_preds=True)
        masked_share = float(binary.float().mean())
        _check(recon.shape == binary.shape == xs.shape
               and math.isfinite(float(loss_p))
               and abs(masked_share - cfg.masking_ratio) < 1e-3,
               f"return_preds: {tuple(recon.shape)} {tuple(binary.shape)} "
               f"masked share {masked_share}")

        # at the seeded initial weights every attention weight is held to
        # the f32 twin; after the 30 steps the global norm is, and each
        # attention weight to what bf16 rounding alone gives it on the CPU
        init = init_mae_(MAE(cfg, device=torch.device("cuda"),
                             dtype=torch.bfloat16), seed=SEED)
        at_init = _mae_grad_check(init, ds)
        del init
        trained = _mae_grad_check(state.model, ds, witness=True)
        step_ms, peak = _time_steps(state, tcfg, ds, 32, 5)
        ab = _k9_ab(_train_stepper(state, tcfg, ds, 32))
        big = tcfg.replace(batch_size=256, grad_accum=8)
        big_ms, big_peak = _time_steps(state, big, ds, 256, 1)
        profiles = {"MAE": _profile_steps(state, tcfg, ds, "MAE", card)}
        k6_fams = ("K6 fwd", "K6 bwd dq", "K6 bwd dk/dv")
        _check(all(profiles["MAE"]["families"].get(f, 0.0) > 0
                   for f in k6_fams),
               f"the MAE profile lacks a K6 family: "
               f"{sorted(profiles['MAE']['families'])}")
        del state

        # the recipe's next step: the MAE's encoder grafted into Franky
        seen = {}
        real_run = trainer.run_train_model

        def snapshot(model, *a, **kw):
            seen.update({k: v.clone() for k, v in
                         model.brain_model.encoder.state_dict().items()})
            return real_run(model, *a, **kw)

        trainer.run_train_model = snapshot
        try:
            franky = train_cli.main([
                "--config", str(repo / "configs" / "franky.yaml"),
                "--data", "synthetic", "--synthetic-trials", "256",
                "--steps", "2", "--batch-size", "32", "--eval-interval",
                "2", "--init-encoder-from", str(run_dir), "--exp-name",
                "franky", "--save-folder", tmp])
        finally:
            trainer.run_train_model = real_run
        grafted = (set(seen) == set(mae_encoder) and all(
            torch.equal(seen[k], mae_encoder[k]) for k in seen))
        f_records = [json.loads(line) for line in (
            Path(tmp) / "franky" / "metrics.jsonl").read_text().splitlines()]
        f_val = [r["val/loss"] for r in f_records if "val/loss" in r]
        _check(grafted, "Franky's encoder is not the MAE checkpoint's")
        _check(franky.step == 2 and len(f_val) == 1
               and math.isfinite(f_val[0]),
               f"grafted Franky: step {franky.step}, val {f_val}")
        profiles["Franky"] = _profile_steps(
            franky, _train_config(Path(tmp) / "franky"), ds,
            "Franky (grafted)", card)
        del franky
    grad_errs, trained_errs = at_init["errs"], trained["errs"]
    witness = trained["witness"]
    worst = max(grad_errs, key=grad_errs.get)
    t_worst = max(witness, key=trained_errs.get)
    margin = {n: trained_errs[n] / max(GRAD_TOL, WITNESS_FACTOR * witness[n])
              for n in witness}
    tightest = max(margin, key=margin.get)
    print(f"phase 13 MAE pretraining: configs/mae.yaml ({cfg.window_size}x"
          f"{cfg.n_electrodes} window, {cfg.block_size} tokens, "
          f"{int(cfg.block_size * (1 - cfg.masking_ratio))} kept, "
          f"{cfg.n_layers}+{cfg.n_dec_layers} blocks of width {cfg.dim}, f32 "
          f"params, bf16 compute), {TRAIN_STEPS} steps at B=32 through the "
          f"train CLI in {run_s:.1f} s: train loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (logged {len(losses)}), val {val[-1]:.4f}, "
          f"samples/s in the log {rate[-1]:.1f}, launches {flash} (K6 and "
          f"K7 = {cfg.n_layers} per forward, K6-bwd and K7-bwd = "
          f"{cfg.n_dec_layers} per step), K9 {k9_want} ({cfg.n_layers} per "
          f"forward: the decoder's f32 stream keeps the module chain), K1-K5 "
          f"0, plain twins and the plain attention path 0 calls, checkpoint "
          f"{best} restored bitwise, "
          f"return_preds {tuple(recon.shape)} with {masked_share:.4f} masked "
          f"| B=1 card vs f32 CPU twin gradients at the seeded initial "
          f"weights ({at_init['s']:.1f} s): global norm rel err "
          f"{grad_errs['global_norm']:.3e}, worst attention weight {worst} "
          f"{grad_errs[worst]:.3e} (tol {GRAD_TOL}), its K6/K7 backward "
          f"launches vs f32 twins on their own inputs "
          f"{at_init['kernel_rel']:.3e} (tol {FLASH_TOL}); after the "
          f"{TRAIN_STEPS} steps "
          f"({trained['s']:.1f} s): global norm "
          f"{trained_errs['global_norm']:.3e} (tol {GRAD_TOL}), K6/K7 "
          f"backward vs twins {trained['kernel_rel']:.3e} (tol {FLASH_TOL}), "
          f"worst attention weight {t_worst} {trained_errs[t_worst]:.3e} "
          f"where bf16 compute on the CPU gives {witness[t_worst]:.3e}; "
          f"closest to its tol max({GRAD_TOL}, {WITNESS_FACTOR} x bf16 CPU) "
          f"{tightest} {trained_errs[tightest]:.3e} vs {witness[tightest]:.3e}"
          f" | B=32 "
          f"step {step_ms:.1f} ms, {32e3 / step_ms:.1f} samples/s, peak "
          f"{peak:.2f} GiB; in turns {_ab_note(ab)} | B=256 grad_accum 8 "
          f"step {big_ms:.1f} ms, peak "
          f"{big_peak:.2f} GiB | graft: Franky (configs/franky.yaml) with "
          f"--init-encoder-from the MAE run, encoder equal to the MAE "
          f"checkpoint's bitwise before step 1, 2 steps, val "
          f"{f_val[0]:.4f} | {card}", flush=True)
    _check(max(grad_errs.values()) <= GRAD_TOL
           and trained_errs["global_norm"] <= GRAD_TOL
           and max(margin.values()) <= 1.0,
           f"card vs CPU gradients: {grad_errs}, after training "
           f"{trained_errs}, bf16 on the CPU {witness}")
    _check(max(at_init["kernel_rel"], trained["kernel_rel"]) <= FLASH_TOL,
           f"K6/K7 backward vs twins on the MAE's own tensors: "
           f"{at_init['kernel_rel']}, trained {trained['kernel_rel']}")
    return {"launches": flash, "k9_launches": k9_want, "step_ms": step_ms,
            "peak_gib": peak, "big_ms": big_ms, "big_peak_gib": big_peak,
            "grad": grad_errs, "profiles": profiles, "step_ab": ab}


def _k9_inputs(b: int, t: int, hidden: int, kind: str, gen):
    """bf16 x [B, T, 256] and serving weights (bf16 nn.Linear layout), f32
    norm parameters, no bias for RMSNorm."""
    import torch
    e = 256
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    nb = 0.1 * rnd(e) if kind == "layernorm" else None
    w = lambda o, i: (rnd(o, i) / i ** 0.5).to(torch.bfloat16)
    return (rnd(b, t, e).to(torch.bfloat16), 1.0 + 0.1 * rnd(e), nb,
            w(hidden, e), w(hidden, e), w(e, hidden))


def phase_k9(card: str) -> dict:
    """K9 in both norms against its twin at the encoder's shapes (B=2, 32
    and 128) and the Perceiver's, and the RMSNorm kind at SimpleMAE's
    encoder shape (B=32 x 192 kept timesteps, one warpgroup a CTA):
    out and the update out - x within K9_TOL, two launches bitwise equal;
    the kernel's, the twin's and the eager module chain's times, the
    kernel's issued TFLOP/s, bound, registers and CTAs an SM."""
    import torch
    from frankenstein_tpu_torch.ops.cuda import fused_mlp as k9
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    results = {}
    for kind in ("layernorm", "rmsnorm"):
        shapes = [("encoder", 2, 6144, 1024), ("encoder B=32", 32, 6144, 1024),
                  ("encoder B=128", 128, 6144, 1024),
                  ("Perceiver", 128, 32, 512)]
        if kind == "rmsnorm":
            # SimpleMAE's encoder blocks (phase 20): 192 kept timesteps of
            # 768 at B=32, one warpgroup a CTA at hidden 1024
            shapes.append(("SimpleMAE encoder", 32, 192, 1024))
        for shape, b, t, hidden in shapes:
            args = _k9_inputs(b, t, hidden, kind, gen)
            run = lambda: k9.fused_norm_swiglu(*args, kind=kind)
            out, again = run(), run()
            ref = k9.fused_norm_swiglu_ref(*args, kind=kind)
            torch.cuda.synchronize()
            bitwise = torch.equal(out, again)
            err = _max_err(out, ref)
            rel = err / float(ref.float().abs().max())
            upd = ref.float() - args[0].float()
            upd_rel = (_max_err(out.float() - args[0].float(), upd)
                       / float(upd.abs().max()))
            finite = bool(torch.isfinite(out).all())
            del out, again, ref, upd
            big = b * t > 2 * 6144
            ms = _time_ms(run, iters=5 if big else 10)
            plain_ms = _time_ms(lambda: k9.fused_norm_swiglu_ref(
                *args, kind=kind), iters=2 if big else 3, warmup=1)
            chain_ms = _time_ms(lambda: k9.reference_chain(*args, kind=kind),
                                iters=5 if big else 10)
            rows, e = b * t, args[0].shape[-1]
            ops = 6 * rows * e * hidden
            bound = _bound(4 * rows * e + _nbytes(*args[1:]), ops)
            regs, ctas = k9.occupancy(e, kind, rows=rows)
            print(f"phase 14 K9 fused_norm_swiglu {kind} {shape} B={b} T={t} "
                  f"E={e} hidden={hidden} bf16: out max_abs_err {err:.3e} "
                  f"(rel {rel:.3e}), update out - x rel err {upd_rel:.3e}, "
                  f"tol {K9_TOL} x max|twin|, two launches bitwise equal "
                  f"{bitwise} | kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} "
                  f"TFLOP/s issued), plain {plain_ms:.4f} ms, eager module "
                  f"chain {chain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                  f"({bound['bound_by']}) | registers / CTAs an SM {regs} / "
                  f"{ctas} | {card}", flush=True)
            _check(finite, f"K9 {kind} {shape} not finite")
            _check(rel <= K9_TOL and upd_rel <= K9_TOL,
                   f"K9 {kind} {shape} disagrees with its twin: {rel}, "
                   f"update {upd_rel}")
            _check(bitwise, f"K9 {kind} {shape} is not deterministic")
            results[(kind, shape)] = {"max_abs_err": err, "ms": ms,
                                      "plain_ms": plain_ms,
                                      "chain_ms": chain_ms,
                                      "occupancy": (regs, ctas),
                                      "library_ms": None, **bound}
            del args
    return results


def phase_repair(card: str) -> None:
    """Inputs no kernel takes run the plain routes: one step (and one eval
    over 8 trials) through the train CLI at B=1 of Franky and of the MAE in
    f32 (``--no-bf16``), and of an MAE of 100 channels in bf16."""
    import tempfile
    from pathlib import Path

    import torch
    from frankenstein_tpu_torch.models import layers
    from frankenstein_tpu_torch.ops import attention as tattn
    from frankenstein_tpu_torch.ops.cuda import flash_attention as k67
    from frankenstein_tpu_torch.ops.cuda import fused_mlp as k9
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    from frankenstein_tpu_torch.train import __main__ as train_cli

    repo = Path(__file__).resolve().parent
    watched = [(tattn, "_softmax_av"), (layers.SwiGLU, "forward"),
               (k67, "flash_attention_ref"), (k67, "flash_attention_bwd_ref"),
               (k1, "slab_rope_attention_ref"),
               (k1, "slab_rope_attention_bwd_ref"),
               (k9, "fused_norm_swiglu_ref")]
    runs = {"Franky f32": ["--config", str(repo / "configs" / "franky.yaml"),
                           "--no-bf16"],
            "MAE f32": ["--config", str(repo / "configs" / "mae.yaml"),
                        "--no-bf16"],
            "MAE 100 channels bf16": ["--model", "mae", "--channels", "100"]}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, args) in enumerate(runs.items()):
            _reset_launches()
            _reset_flash()
            t0 = time.perf_counter()
            with _CountCalls(watched) as calls:
                train_cli.main([*args, "--data", "synthetic",
                                "--synthetic-trials", "8", "--batch-size",
                                "1", "--steps", "1", "--eval-interval", "1",
                                "--exp-name", f"run{i}", "--save-folder",
                                tmp])
                torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launched = {k: n for k, n in {**_read_launches(),
                                          **_read_flash()}.items() if n}
            records = [json.loads(line) for line in (
                Path(tmp) / f"run{i}" / "metrics.jsonl").read_text()
                .splitlines()]
            # the trainer raises on a non-finite train loss by itself
            val = [r["val/loss"] for r in records if "val/loss" in r]
            plain = {k: n for k, n in calls.calls.items() if n}
            print(f"phase 15 repair: {name}, 1 step at B=1 and an eval over "
                  f"8 trials through the train CLI in {run_s:.1f} s: train "
                  f"loss finite, val loss {val}, kernel launches "
                  f"{launched or 'none'}, plain calls {plain} | {card}",
                  flush=True)
            _check(len(val) == 1 and math.isfinite(val[0]),
                   f"{name}: val losses {val}")
            twins = [k for k in plain if k.endswith("_ref")]
            _check(not twins, f"{name}: twins ran on the card: {twins}")
            _check(plain.get("attention._softmax_av", 0) > 0,
                   f"{name}: the plain attention path did not run")
            # 4 encoder blocks over 1 training and 8 eval forwards
            want = {} if "f32" in name else {"K9": 4 * 9}
            _check(launched == want, f"{name}: launches {launched}, want "
                   f"{want}")


def _k8_inputs(b: int, gen):
    """GPT-2 124M's head: bf16 x [B, 768], f32 ln_f, the bf16 tied table
    [50304, 768] at GPT-2's init scale."""
    import torch
    e, v = 768, 50304
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    return (rnd(b, e).to(torch.bfloat16), 1.0 + 0.1 * rnd(e), 0.1 * rnd(e),
            (0.02 * rnd(v, e)).to(torch.bfloat16))


def _k8_chain(x, w, bias, wte, k: int):
    """The eager chain K8 stands beside: layer norm, the bf16 head, top-k
    and logsumexp, four PyTorch calls."""
    import torch
    import torch.nn.functional as F
    h = F.layer_norm(x.float(), (x.shape[-1],), w, bias, 1e-5).to(wte.dtype)
    logits = (h @ wte.t()).float()
    return torch.topk(logits, k), torch.logsumexp(logits, dim=-1)


def _topk_gap(idx, ref_vals, ref_idx, logits) -> tuple:
    """Chosen indices that differ from the reference's, and the largest
    |reference logit at such a choice - reference value at its rank|: a
    near-tie when small."""
    import torch
    differ = idx != ref_idx
    if not bool(differ.any()):
        return 0, 0.0
    near = (torch.gather(logits, 1, idx) - ref_vals).abs()
    return int(differ.sum()), float(near[differ].max())


def _k8_check(name: str, got, again, ref, logits, k: int, card: str,
              note: str = "") -> tuple:
    """K8's outputs against its twin's: values and logz within K8_TOL,
    every differing index a near-tie, no index repeated or past V, two
    launches bitwise equal; prints one line. Returns (value, logz) max
    errors."""
    import torch
    bitwise = all(torch.equal(a, c) for a, c in zip(got, again))
    err_v, err_z = _max_err(got[0], ref[0]), _max_err(got[2], ref[2])
    differ, gap = _topk_gap(got[1], ref[0], ref[1], logits)
    print(f"phase 16 K8 {name}: vals max_abs_err {err_v:.3e}, logz "
          f"{err_z:.3e}, indices off the twin's {differ} (largest near-tie "
          f"gap {gap:.3e}), tol {K8_TOL}, two launches bitwise equal "
          f"{bitwise}{note} | {card}", flush=True)
    _check(all(bool(torch.isfinite(a).all()) for a in (got[0], got[2])),
           f"K8 {name} not finite")
    _check(max(err_v, err_z, gap) <= K8_TOL,
           f"K8 {name} disagrees with its twin: vals {err_v}, logz {err_z}, "
           f"index gap {gap}")
    _check(all(len(set(r.tolist())) == k for r in got[1])
           and int(got[1].max()) < logits.shape[1],
           f"K8 {name} repeats an index or points past V")
    _check(bitwise, f"K8 {name} is not deterministic")
    return err_v, err_z


def _k8_profile(batches, k: int) -> dict:
    """Each K8 launch's device ms a call (torch.profiler) at each batch of
    ``batches``, GPT-2's head, ``_k8_inputs`` from the phase's seed."""
    import torch
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    out = {}
    for b in batches:
        x, w, bias, wte = _k8_inputs(b, gen)
        out[b] = _by_kernel(lambda: k8.lm_head_topk(x, w, bias, wte, k=k),
                            r"(lm_head_norm|lm_head_topk_wgmma)",
                            {"lm_head_norm", "lm_head_topk_wgmma"})
    return out


def _k8_device_ms(batches, k: int) -> dict:
    """``_k8_profile`` in a fresh process: late in this one torch.profiler
    drops records (PERF.md §7)."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, chip_smoke as c; "
            f"print(json.dumps(c._k8_profile({list(batches)}, {k})))")
    done = subprocess.run([sys.executable, "-c", code], cwd=here,
                          capture_output=True, text=True)
    _check(done.returncode == 0, f"K8's profile failed: {done.stderr[-2000:]}")
    last = done.stdout.strip().splitlines()[-1]
    return {int(b): v for b, v in json.loads(last).items()}


def phase_k8(card: str) -> dict:
    """K8 (``csrc/lm_head_topk.cu``: the LayerNorm pre-pass, then the
    persistent TMA-ring wgmma head with its top-k, grid barrier and merge)
    against its twin at GPT-2's head, B = 8, 32, 128 and 160, with each
    launch's device time (torch.profiler) beside the bound, the eager chain
    and, at B=128, the port's dense route; then B=1, a ragged vocab whose
    true top-k lies in its tail, k=32 and a table wider than 768; the
    forced tie; the launch (batch width, ring stages, registers)."""
    import torch
    from frankenstein_tpu_torch.ops import norms
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    k, e, v = 10, 768, 50304
    results = {}
    device = _k8_device_ms((8, 32, 128, 160), k)
    for b in (8, 32, 128, 160):
        x, w, bias, wte = _k8_inputs(b, gen)
        run = lambda: k8.lm_head_topk(x, w, bias, wte, k=k)
        got, again = run(), run()
        ref = k8.lm_head_topk_ref(x, w, bias, wte, k=k)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, c) for a, c in zip(got, again))
        err_v, err_z = _max_err(got[0], ref[0]), _max_err(got[2], ref[2])
        differ, gap = _topk_gap(got[1], ref[0], ref[1],
                                k8.head_logits_ref(x, w, bias, wte))
        ms = _time_ms(run)
        by_launch = device[b]
        device_ms = sum(by_launch.values())
        launch = k8.info(b, k, k8.grid_size(x.device, v))
        plain_ms = _time_ms(lambda: k8.lm_head_topk_ref(x, w, bias, wte,
                                                        k=k), iters=3)
        chain_ms = _time_ms(lambda: _k8_chain(x, w, bias, wte, k))
        outputs = b * k * (4 + 8) + b * 4
        bound = _bound(_nbytes(x, w, bias, wte) + outputs, 2 * b * e * v)
        dense, extra = "", {}
        if b == 128:
            # the port's dense route: ln_f on the bf16 model, the f32
            # serving table, torch.topk (decode_step + sampling._pick)
            table = wte.float().t()
            wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
            extra["dense_ms"] = _time_ms(lambda: torch.topk(
                norms.layer_norm(x, wb, bb).float() @ table, k))
            dense = f", the port's dense route {extra['dense_ms']:.4f} ms"
            del table
        print(f"phase 16 K8 lm_head_topk B={b} E={e} V={v} k={k} bf16: vals "
              f"max_abs_err {err_v:.3e}, logz {err_z:.3e}, indices off the "
              f"twin's {differ} (largest near-tie gap {gap:.3e}), tol "
              f"{K8_TOL}, two launches bitwise equal {bitwise} | back to "
              f"back {ms:.4f} ms a call; device a call (profiler, a fresh "
              f"process): "
              + ", ".join(f"{name} {t:.4f} ms" for name, t in
                          by_launch.items()) +
              f", {device_ms:.4f} ms in all, {device_ms / bound['bound_ms']:.2f}x "
              f"the bound | plain {plain_ms:.4f} ms, eager chain "
              f"{chain_ms:.4f} ms{dense}, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}) | launch: width {launch['width']}, "
              f"{launch['stages']} ring stages, {launch['smem']} B shared, "
              f"{launch['regs']} registers, {launch['ctas']} CTA an SM, "
              f"{launch['local_bytes']} B spilled | {card}", flush=True)
        _check(all(bool(torch.isfinite(a).all()) for a in (got[0], got[2])),
               f"K8 B={b} not finite")
        _check(max(err_v, err_z, gap) <= K8_TOL,
               f"K8 B={b} disagrees with its twin: vals {err_v}, logz "
               f"{err_z}, index gap {gap}")
        _check(all(len(set(r.tolist())) == k for r in got[1]),
               f"K8 B={b} repeats an index")
        _check(bitwise, f"K8 B={b} is not deterministic")
        _check(launch["local_bytes"] == 0, f"K8 B={b} spills: {launch}")
        results[b] = {"max_abs_err": max(err_v, err_z), "ms": ms,
                      "device_ms": device_ms, "plain_ms": plain_ms,
                      "chain_ms": chain_ms, "library_ms": None, **bound,
                      **extra}
        del x, wte, got, again, ref

    # B=1; k=32 at B=160; a table wider than GPT-2 124M's (GPT-2 medium's
    # 1024); V=50257, whose last block holds 81 rows, with row 7's top-10 in
    # that tail and every logit of row 1 negative (the zero rows past V
    # would outrank them all if they were not masked)
    for b, ek, kk in ((1, 768, 10), (160, 768, 32), (8, 1024, 10)):
        x, w, bias, wte = _k8_inputs(b, gen)
        if ek != e:
            x = torch.randn(b, ek, generator=gen, device="cuda").to(
                torch.bfloat16)
            w, bias = w[:1].expand(ek).contiguous(), bias[:1].expand(
                ek).contiguous()
            wte = (0.02 * torch.randn(v, ek, generator=gen, device="cuda")
                   ).to(torch.bfloat16)
        got = k8.lm_head_topk(x, w, bias, wte, k=kk)
        again = k8.lm_head_topk(x, w, bias, wte, k=kk)
        _k8_check(f"B={b} E={ek} V={v} k={kk}", got, again,
                  k8.lm_head_topk_ref(x, w, bias, wte, k=kk),
                  k8.head_logits_ref(x, w, bias, wte), kk, card)
        del x, wte
    vt = 50257
    x, w, bias, wte = _k8_inputs(8, gen)
    wte = wte[:vt].contiguous()
    w, bias = torch.ones_like(w), torch.zeros_like(bias)
    xf = x[7].float()
    a = (xf - xf.mean()) / xf.std(unbiased=False)
    r = torch.randn(e, generator=gen, device="cuda")
    r = r - r.mean()
    r = r - (r @ a) / (a @ a) * a
    brow = r / r.std(unbiased=False)
    x[1] = brow.to(torch.bfloat16)
    wte.copy_((-0.01 * brow + 0.001 * torch.randn(
        vt, e, generator=gen, device="cuda")).to(torch.bfloat16))
    scale = torch.linspace(0.5, 0.25, 12, device="cuda")[:, None]
    wte[vt - 12:] = (scale * (a - 0.02 * brow)).to(torch.bfloat16)
    got = k8.lm_head_topk(x, w, bias, wte, k=k)
    again = k8.lm_head_topk(x, w, bias, wte, k=k)
    logits = k8.head_logits_ref(x, w, bias, wte)
    tail_ok = (got[1][7].tolist() == list(range(vt - 12, vt - 2))
               and got[1][1].tolist() == list(range(vt - 1, vt - 11, -1)))
    _k8_check(f"ragged V={vt}, row 7's top-10 in the last block's tail, row "
              f"1's logits all negative", got, again,
              k8.lm_head_topk_ref(x, w, bias, wte, k=k), logits, k, card,
              note=f", rows 1 and 7 take the tail's rows {tail_ok}")
    _check(float(logits[1].max()) < 0 and tail_ok,
           f"K8 ragged tail: rows {got[1][1].tolist()} {got[1][7].tolist()}")
    del x, wte, logits

    # ties: vocab rows 3 and 7 equal and aligned with row 0's h
    x, w, bias, wte = _k8_inputs(8, gen)
    h0 = torch.nn.functional.layer_norm(x[:1].float(), (e,)) * w + bias
    wte[3] = wte[7] = (0.2 * h0[0]).to(torch.bfloat16)
    ties = [(idx[0, :2].tolist(), float(vals[0, 0]) == float(vals[0, 1]))
            for vals, idx, _ in (k8.lm_head_topk(x, w, bias, wte, k=4),
                                 k8.lm_head_topk_ref(x, w, bias, wte, k=4))]
    print(f"phase 16 K8 forced tie (vocab rows 3 and 7 equal): kernel top "
          f"two {ties[0][0]} equal {ties[0][1]}, twin {ties[1][0]} equal "
          f"{ties[1][1]} | {card}", flush=True)
    _check(ties == [([3, 7], True)] * 2, f"K8 ties: {ties}")
    return results


def phase_k10(card: str) -> dict:
    import torch
    from frankenstein_tpu_torch.ops import rope
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    b, t, h, d, p = 2, 6144, 8, 32, 256
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    # activations at the JAX package's qk_int8 test scale (0.5)
    act = lambda n: (0.5 * torch.randn(n, t, h * d, generator=gen,
                                       device=dev)).to(torch.bfloat16)
    q, k, v = act(b), act(b), act(b)
    cos, sin = rope.folded_tables(rope.build_rope_cache(d, t, device=dev),
                                  1)
    kw = dict(n_heads=h, tok_per_time=p)
    run = lambda: k1.slab_rope_attention(q, k, v, cos, sin, qk_int8=True,
                                         **kw)
    (out, lse), (out2, lse2) = run(), run()
    codes, scales = k1.rope_quantize_k(k, cos, sin, n_heads=h)
    ref_codes, ref_scales = k1.rope_quantize_k_ref(k, cos, sin, n_heads=h)
    ref_out, ref_lse = k1.slab_rope_attention_int8_ref(q, k, v, cos, sin,
                                                       **kw)
    exact = k1.slab_rope_attention(q, k, v, cos, sin, **kw)
    # a kernel that dequantized every key tile with chunk 0's K scale
    chunk0 = k1.slab_rope_attention_fwd_int8(
        q, codes, scales[..., :1].expand_as(scales).contiguous(), v, cos,
        sin, **kw)
    torch.cuda.synchronize()
    bitwise = torch.equal(out, out2) and torch.equal(lse, lse2)
    # a code may differ from the twin's only on a .5 tie
    rot = rope.apply_rope_folded(k, cos.repeat(1, h), sin.repeat(1, h))
    per = ref_scales.transpose(1, 2).repeat_interleave(1024, dim=1)
    pre = (rot.float().reshape(b, t, h, d) / per[..., None]).reshape(b, t,
                                                                    -1)
    off_tie = ((codes != ref_codes)
               & ((((pre.abs() % 1.0) - 0.5).abs()) > CODE_WINDOW))
    n_differ, n_off_tie = int((codes != ref_codes).sum()), int(off_tie.sum())
    scales_equal = torch.equal(scales, ref_scales)
    top = float(ref_out.abs().max())
    errs = lambda o, l_: (_max_err(o, ref_out) / top, _max_err(l_, ref_lse))
    passes = lambda e_: e_[0] <= K10_OUT_TOL and e_[1] <= K10_LSE_TOL
    err = errs(out, lse)
    # the check's power: K1's output and the chunk-0-scale kernel must fail
    controls = {"K1": errs(*exact), "chunk-0 scale": errs(*chunk0)}
    diff = (out.float() - exact[0].float()).abs()
    drift, drift_mean = float(diff.max()), float(diff.mean())

    # K10 forward + K4 backward through the autograd Function, against the
    # twins' chain (K10's twin, then K4's on its out and lse)
    dout = torch.randn(b, t, h * d, generator=gen,
                       device=dev).to(torch.bfloat16)
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]
    before = (k1.launches_int8, k1.launches_bwd)
    k1.SlabRopeAttention.apply(*leaves, cos, sin, h, p, True).backward(dout)
    torch.cuda.synchronize()
    through = (k1.launches_int8 - before[0], k1.launches_bwd - before[1])
    want = k1.slab_rope_attention_bwd_ref(
        *(a.float() for a in (q, k, v, cos, sin, ref_out, ref_lse, dout)),
        **kw)
    grad_rel = [_max_err(a.grad, w_) / float(w_.abs().max())
                for a, w_ in zip(leaves, want)]

    main_ms = _time_ms(lambda: k1.slab_rope_attention_fwd_int8(
        q, codes, scales, v, cos, sin, **kw))
    pre_ms = _time_ms(lambda: k1.rope_quantize_k(k, cos, sin, n_heads=h))

    def calls(qk_int8):   # ten back-to-back calls per timed turn
        return lambda: [k1.slab_rope_attention(q, k, v, cos, sin,
                                               qk_int8=qk_int8, **kw)
                        for _ in range(10)]

    turns = _in_turns({True: calls(True), False: calls(False)})
    spread = {on: [x / 10 for x in turns[on]["ms"]] for on in turns}
    ms, k1_ms = spread[True][0], spread[False][0]
    plain_ms = _time_ms(lambda: k1.slab_rope_attention_int8_ref(
        q, k, v, cos, sin, **kw), iters=3)
    pairs = _slab_pairs(t, p)
    bound = _bound(_nbytes(q, k, v, cos, sin, out, lse),
                   2 * d * h * b * pairs, int8_ops=2 * d * h * b * pairs)
    # back to back at B=2, 32 and 128 beside K1, the exp floor and the
    # issued rate; the B=32 call split by kernel
    back = {2: (_time_ms(run), _time_ms(lambda: k1.slab_rope_attention(
        q, k, v, cos, sin, **kw)))}
    for bb in (32, 128):
        qb, kb, vb = act(bb), act(bb), act(bb)
        back[bb] = tuple(_time_ms(lambda on=on: k1.slab_rope_attention(
            qb, kb, vb, cos, sin, qk_int8=on, **kw), iters=3)
            for on in (True, False))
        if bb == 32:
            split = _by_kernel(
                lambda: k1.slab_rope_attention(qb, kb, vb, cos, sin,
                                               qk_int8=True, **kw),
                r"(slab_rope_attn_fwd_int8_prep|slab_rope_attn_fwd_int8_wgmma"
                r"|rope_absmax_k|rope_quantize_k)",
                {"slab_rope_attn_fwd_int8_prep",
                 "slab_rope_attn_fwd_int8_wgmma", "rope_absmax_k",
                 "rope_quantize_k"})
        del qb, kb, vb
    ms_b32, k1_b32 = back[32]
    floor = {bb: h * bb * pairs / EXP2_PER_S * 1e3 for bb in back}
    occ = {(pas, pp): k1.fwd_int8_occupancy(pas, d, pp)
           for pas in k1.FWD_PASSES for pp in (p, 96)}
    note = lambda sp: f"{sp[0]:.4f} ({sp[1]:.4f}-{sp[2]:.4f})"
    print(f"phase 17 K10 slab_rope_attention qk_int8 B={b} T={t} E={h * d} "
          f"H={h} P={p} bf16: K codes off the twin's {n_differ} ({n_off_tie}"
          f" off a .5 tie), scales equal {scales_equal}, out max_abs_err "
          f"{err[0] * top:.3e} = {err[0]:.3e} of max |twin| {top:.3e} (tol "
          f"{K10_OUT_TOL}), lse {err[1]:.3e} (tol {K10_LSE_TOL}); the same "
          f"check on K1's output: out {controls['K1'][0]:.3e}, lse "
          f"{controls['K1'][1]:.3e}; on a kernel that reads chunk 0's K "
          f"scale for every tile: out {controls['chunk-0 scale'][0]:.3e}, "
          f"lse {controls['chunk-0 scale'][1]:.3e}; drift from K1's out max "
          f"{drift:.3e} mean {drift_mean:.3e} (tol {QK_INT8_DRIFT}), K10 + "
          f"K4 gradients rel err "
          f"{grad_rel[0]:.3e}/{grad_rel[1]:.3e}/{grad_rel[2]:.3e} (tol "
          f"{K4_TOL}, launches K10 {through[0]} K4 {through[1]}), two "
          f"launches bitwise equal {bitwise} | in turns, medians (range) of "
          f"{TIMING_REPEATS}: K10 {note(spread[True])} ms, K1 "
          f"{note(spread[False])} ms; K10 without its K pre-pass "
          f"{main_ms:.4f} ms, "
          f"K pre-pass alone {pre_ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}) | back to "
          f"back, K10 / K1 ms, K10's exp floor and issued TOP/s: " +
          ", ".join(f"B={bb} {k10_ms:.3f} / {k1_ms_:.3f} (floor "
                    f"{floor[bb]:.4f}, {4 * d * h * bb * pairs / k10_ms / 1e9:.1f})"
                    for bb, (k10_ms, k1_ms_) in back.items()) +
          " | B=32 by kernel (torch.profiler, ms a call): " +
          ", ".join(f"{name} {ms_:.3f}" for name, ms_ in split.items()) +
          " | registers / CTAs an SM: " +
          ", ".join(f"{pas} P={pp} {r} / {c}"
                    for (pas, pp), (r, c) in occ.items()) +
          f" | {card}", flush=True)
    _check(bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
           "K10 output not finite")
    _check(n_off_tie == 0 and scales_equal,
           f"K10 codes off ties {n_off_tie}, scales equal {scales_equal}")
    _check(passes(err), f"K10 disagrees with its twin: out {err[0]} of max "
           f"|twin|, lse {err[1]}")
    _check(not any(passes(e_) for e_ in controls.values()),
           f"the K10 check cannot tell K10 from {controls}")
    _check(0.0 < drift <= QK_INT8_DRIFT, f"K10 drift from K1 {drift}")
    _check(max(grad_rel) <= K4_TOL and through == (1, 1),
           f"K10 + K4 gradients {grad_rel}, launches {through}")
    _check(bitwise, "K10 is not deterministic")
    return {"max_abs_err": max(err[0] * top, err[1]), "ms": ms,
            "main_ms": main_ms, "pre_ms": pre_ms, "k1_ms": k1_ms,
            "plain_ms": plain_ms, "ms_b32": ms_b32, "k1_ms_b32": k1_b32,
            "back": back, "floor": floor, "split": split, "occupancy": occ,
            "controls": controls, "library_ms": None, **bound}


def _qk_int8_step(gen) -> dict:
    """Path B in training: one Franky step at B=2 (f32 parameters, bf16
    compute) with ``qk_int8`` (K10 forward, K4 backward on its out and lse)
    and the same step without it; launches, finiteness and the relative
    difference of the global gradient norm."""
    import torch
    from frankenstein_tpu_torch.config import FrankyConfig
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.models.weights import init_franky_
    dev = torch.device("cuda")
    cfg = FrankyConfig()
    enc = cfg.brain.encoder
    x = torch.randn(2, enc.window_size, enc.n_electrodes, generator=gen,
                    device=dev)
    y = torch.randint(0, cfg.gpt.vocab_size, (2, cfg.max_tokens),
                      generator=gen, device=dev)
    norms, launches = {}, {}
    for int8 in (True, False):
        model = init_franky_(Franky(_qk_int8_config(cfg) if int8 else cfg,
                                    device=dev, dtype=torch.bfloat16),
                             seed=SEED)
        _reset_launches()
        loss, _ = model(x, y)
        loss.backward()
        torch.cuda.synchronize()
        launches[int8] = _read_launches()
        grads = [p.grad.float() for p in model.parameters()
                 if p.grad is not None]
        _check(math.isfinite(float(loss.detach()))
               and all(bool(torch.isfinite(g).all()) for g in grads),
               f"qk_int8={int8} training step not finite")
        norms[int8] = float(torch.sqrt(sum((g * g).sum() for g in grads)))
        del model, grads
    got = {key: launches[True][key] for key in ("K1", "K4", "K10")}
    want = {"K1": 0, "K4": enc.n_layers, "K10": enc.n_layers}
    _check(got == want, f"qk_int8 step launches {got}, want {want}")
    _check(launches[False]["K10"] == 0, "K10 ran without qk_int8")
    rel = abs(norms[True] - norms[False]) / norms[False]
    _check(rel <= GRAD_TOL, f"qk_int8 step's gradient norm off by {rel}")
    return {"launches": got, "grad_norm_rel": rel}


def _route_check(model, x, qw, int8_kv: bool) -> tuple:
    """One decode step on one prefilled state (a ``QuantCache`` with
    ``int8_kv``): K8's top-k and logz against the dense route's
    (``decode_step``, ``exact_topk``, ``torch.logsumexp``) on a copy of the
    same cache. Returns (max err, indices off, largest near-tie gap)."""
    import torch
    from frankenstein_tpu_torch.config import GPT2_EOT
    from frankenstein_tpu_torch.decode import sampling
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8
    idx0 = torch.full((x.shape[0], 1), GPT2_EOT, dtype=torch.long,
                      device=x.device)
    logits, cache, length = sampling._prefill(
        model, idx0, model.encode(x), model.cfg.max_tokens, int8_kv)
    tok = torch.argmax(logits, dim=-1)
    dense_cache = sampling._tree_map(torch.clone, cache)
    vals, idx, logz, _, _ = model.decode_step_topk(tok, cache, length, qw,
                                                   k=10)
    dense, _, _ = model.decode_step(tok, dense_cache, length, qw)
    dense_vals, dense_idx = k8.exact_topk(dense, 10)
    err = max(_max_err(vals, dense_vals),
              _max_err(logz, torch.logsumexp(dense, dim=-1)))
    return (err, *_topk_gap(idx, dense_vals, dense_idx, dense))


def phase_served(card: str) -> dict:
    """Path A (compact top-k: ``sampling.COMPACT_TOPK``, K8) and path B (the
    ``qk_int8`` encoder, K10) served end to end, under
    FK_QK_INT8_STRICT=1."""
    import os

    import torch
    from frankenstein_tpu_torch.config import GPT2_EOT
    from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
    from frankenstein_tpu_torch.decode import pipeline, sampling

    dev = torch.device("cuda")
    strict = os.environ.get("FK_QK_INT8_STRICT")
    os.environ["FK_QK_INT8_STRICT"] = "1"
    model, model8 = _flagship(), _flagship(qk_int8=True)
    cfg = model.cfg
    enc = cfg.brain.encoder
    steps = cfg.max_tokens
    try:
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        # bf16 block weights: w8a16 requests keep the dense route
        pred = {True: pipeline.make_franky_predictor(model8, ByteTokenizer(),
                                                     top_k=10),
                False: pipeline.make_franky_predictor(model, ByteTokenizer(),
                                                      top_k=10)}
        want = {True: {"K1": 0, "K2": steps, "K2-int8": 0, "K3": 0, "K4": 0,
                       "K5": 0, "K5-int8": 0, "K8": steps,
                       "K9": _k9_blocks(cfg), "K10": enc.n_layers}}
        want[False] = dict(want[True], K1=enc.n_layers, K8=0, K10=0)
        xs, launches = {}, {}
        for b in (128, 8):
            xs[b] = torch.randn(b, enc.window_size, enc.n_electrodes,
                                generator=gen, device=dev)
            for on in (True, False):
                sampling.COMPACT_TOPK = on
                _reset_launches()
                out = pred[on](xs[b])
                torch.cuda.synchronize()
                launches[(b, on)] = _read_launches()
                _check(len(out) == b and all(isinstance(s, str) for s in out),
                       f"phase 18 B={b} predictor returned {out!r}")
                _check(launches[(b, on)] == want[on],
                       f"phase 18 B={b} switches {'on' if on else 'off'}: "
                       f"launches {launches[(b, on)]}, want {want[on]}")

        # the int8-KV request at B=8: K2's int8-KV mode, then K8
        x8 = xs[8]
        sampling.COMPACT_TOPK = True
        pred_kv = pipeline.make_franky_predictor(model8, ByteTokenizer(),
                                                 top_k=10, int8_kv=True)
        _reset_launches()
        out = pred_kv(x8)
        torch.cuda.synchronize()
        launches["int8_kv"] = _read_launches()
        want_kv = dict(want[True], **{"K2-int8": steps})
        _check(len(out) == 8 and all(isinstance(s, str) for s in out),
               f"phase 18 int8-KV predictor returned {out!r}")
        _check(launches["int8_kv"] == want_kv,
               f"phase 18 int8 KV: launches {launches['int8_kv']}, want "
               f"{want_kv}")

        # one decode step's K8 top-k against the dense route's, same state,
        # on the bf16 cache and on the int8 one
        qw = sampling.decode_weights(model, int8_weights=False)
        routes = {kv: _route_check(model, x8, qw, kv) for kv in (False, True)}

        # one B=8 encode through K10 against K1's
        with torch.no_grad():
            ctx8, ctx = model8.brain_model.encoder(x8), \
                model.brain_model.encoder(x8)
        enc_drift = _max_err(ctx8, ctx) / float(ctx.float().abs().max())
        prefix_drift = _max_err(model8.encode(x8), model.encode(x8))

        # in turns: the encoder with qk_int8 on and off, the decode with
        # COMPACT_TOPK on and off (bf16 weights), and the B=8 request with
        # both on and both off
        xb = xs[128]
        idx_b = torch.full((128, 1), GPT2_EOT, dtype=torch.long, device=dev)
        pb = model.encode(xb)

        def decode(on):
            sampling.COMPACT_TOPK = on
            return sampling.generate(model, idx_b, pb, gen,
                                     max_new_tokens=steps, top_k=10,
                                     qweights=qw)

        def request(on):
            sampling.COMPACT_TOPK = on
            return pred[on](x8)

        enc_t = _in_turns({True: lambda: model8.encode(xb),
                           False: lambda: model.encode(xb)})
        dec_t = _in_turns({True: lambda: decode(True),
                           False: lambda: decode(False)})
        req_t = _in_turns({True: lambda: request(True),
                           False: lambda: request(False)})
        rate = {on: 128e3 / (enc_t[on]["ms"][0] + dec_t[on]["ms"][0])
                for on in (True, False)}
        train = _qk_int8_step(gen)
    finally:
        sampling.COMPACT_TOPK = False
        if strict is None:
            del os.environ["FK_QK_INT8_STRICT"]
        else:
            os.environ["FK_QK_INT8_STRICT"] = strict
        del model, model8
    route = lambda kv: (f"max err {routes[kv][0]:.3e}, indices off "
                        f"{routes[kv][1]} (near-tie gap {routes[kv][2]:.3e})")
    print(f"phase 18 served: Franky flagship, bf16 block weights, top-k 10, "
          f"{steps} tokens, FK_QK_INT8_STRICT=1: launches per request with "
          f"COMPACT_TOPK and qk_int8 on {launches[(128, True)]}, off "
          f"{launches[(128, False)]} (the same at B=8), both on with int8 KV "
          f"at B=8 {launches['int8_kv']}; one decode step's K8 top-k vs the "
          f"dense route's: bf16 cache {route(False)}, int8 cache "
          f"{route(True)} (tol {ROUTE_TOL}); B=8 encoder context K10 vs K1 "
          f"rel drift {enc_drift:.3e} (tol {ENCODE_DRIFT}), prefix max drift "
          f"{prefix_drift:.3e} | medians (range) of {TIMING_REPEATS}, in "
          f"turns: B=128 encode qk_int8 on {_note(enc_t[True]['ms'])} ms, "
          f"off {_note(enc_t[False]['ms'])} ms; B=128 decode COMPACT_TOPK on "
          f"{_note(dec_t[True]['ms'])} ms, off {_note(dec_t[False]['ms'])} "
          f"ms; {rate[True]:.1f} sentences/s both on, {rate[False]:.1f} both "
          f"off; B=8 request both on {_note(req_t[True]['ms'])} ms, both off "
          f"{_note(req_t[False]['ms'])} ms | training step B=2 with qk_int8: "
          f"launches {train['launches']}, gradient norm vs exact rel "
          f"{train['grad_norm_rel']:.3e} (tol {GRAD_TOL}) | {card}",
          flush=True)
    for kv, (err, _, gap) in routes.items():
        _check(err <= ROUTE_TOL and gap <= ROUTE_TOL,
               f"K8 vs the dense route (int8 KV {kv}): err {err}, index gap "
               f"{gap}")
    _check(0.0 < enc_drift <= ENCODE_DRIFT,
           f"K10 vs K1 encoder context drift {enc_drift}")
    return {"launches": launches, "encode": enc_t, "decode": dec_t,
            "request": req_t, "rate": rate, "train": train}


def _probe_bound(q, out, lse, p: int, variant: str) -> dict:
    """Bound of one probe call: q, k, v in, out and lse out; QK and PV at
    2*D operations per (query, key) pair of the function the mode computes
    (the visit set for the unmasked modes, the slab pairs else), QK at the
    int8 rate in the int8 modes."""
    from frankenstein_tpu_torch.ops.cuda import slab_probe as sp
    b, t, e = q.shape
    ends = (sp.visit_ends if variant in sp.UNMASKED else sp.slab_ends)(t, p)
    ops = 2 * sp.HEAD_DIM * b * (e // sp.HEAD_DIM) * int(ends.sum())
    qk_int8 = sp.is_int8(variant)
    return _bound(3 * _nbytes(q) + _nbytes(out, lse),
                  ops * (1 if qk_int8 else 2),
                  int8_ops=ops if qk_int8 else 0.0)


def _probe_checks(q, k, v, h: int, twins: dict) -> dict:
    """Every probe mode on [B, T, E] q, k, v against its twin, P=8 and 256
    (the int8 modes at 256), each launch synchronised: (P, variant) ->
    ``slab_probe.probe_error`` of the first rows of out and lse against the
    twin of those rows, ``twins[(P, twin)]`` (computed there where absent);
    ``no_kbd`` -> ``slab_probe.no_kbd_guard`` over all rows, against
    ``kernel``'s twin on the first."""
    import torch
    from frankenstein_tpu_torch.ops.cuda import slab_probe as sp
    from frankenstein_tpu_torch.tools import attn_probe, int8_attr_probe
    checks = {}
    for p in (8, 256):
        variants = attn_probe.VARIANTS + (int8_attr_probe.VARIANTS[1:]
                                          if p == 256 else ())
        for variant in variants:
            run = lambda: sp.slab_attention_probe(
                q, k, v, n_heads=h, tok_per_time=p, variant=variant)
            out, lse = run()
            torch.cuda.synchronize()
            twin = sp.TWINS.get(variant, sp.kernel_ref)
            if (p, twin) not in twins:
                twins[(p, twin)] = twin(
                    *(x[:PROBE_TWIN_ROWS] for x in (q, k, v)), n_heads=h,
                    tok_per_time=p)
            ref, ref_lse = twins[(p, twin)]
            rows = ref.shape[0]
            if variant == "no_kbd":
                again = run()
                torch.cuda.synchronize()
                checks[(p, variant)] = sp.no_kbd_guard(out, lse, again, ref)
                continue
            checks[(p, variant)] = sp.probe_error(variant, out[:rows],
                                                  lse[:rows], ref, ref_lse)
    return checks


def _probe_checks_hold(checks: dict, where: str) -> None:
    from frankenstein_tpu_torch.ops.cuda import slab_probe as sp
    for (p, variant), err in checks.items():
        if variant == "no_kbd":
            _check(sp.guard_holds(err), f"no_kbd guard at P={p}, {where}: "
                   f"{err}")
        else:
            _check(sp.agrees(variant, err), f"probe {variant} at P={p}, "
                   f"{where}, disagrees with its twin: {err}")


def phase_probes(card: str) -> dict:
    import torch
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    from frankenstein_tpu_torch.ops.cuda import slab_probe as sp
    from frankenstein_tpu_torch.tools import attn_probe, int8_attr_probe
    b, t, h, d = PROBE_TWIN_ROWS, attn_probe.T, attn_probe.H, attn_probe.D
    dev = torch.device("cuda")
    # the probe CLIs' own inputs at B=128, and their first rows at B=2
    qb, kb, vb = attn_probe.inputs(PROBE_BATCH, t, dev)
    q, k, v = qb[:b], kb[:b], vb[:b]
    twins = {}
    checks = _probe_checks(q, k, v, h, twins)
    # with identity rope tables K1's pre-pass leaves q and k as they are
    # and its forward is the ``kernel`` mode's instance: K1's out and lse
    # are bitwise the mode's, and within K1_TOL of the mode's twin. So run,
    # K10 is bitwise ``int8_full`` (the same pre-pass arithmetic, then the
    # same forward), both within K10_OUT_TOL / K10_LSE_TOL of K10's twin on
    # those tables, and the pre-passes give bitwise equal K and Q codes and
    # scales
    cos, sin = torch.ones(t, d, device=dev), torch.zeros(t, d, device=dev)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    identity = {}
    for p in (8, 256):
        kw = dict(n_heads=h, tok_per_time=p)
        twin = twins[(p, sp.TWINS["kernel"])]
        got = k1.slab_rope_attention(q, k, v, cos, sin, **kw)
        mode = sp.slab_attention_probe(q, k, v, variant="kernel", **kw)
        errs = [_max_err(g, w) for g, w in zip(got, twin)]
        identity[p] = {"K1 err": max(errs), "K1 ok": max(errs) <= K1_TOL,
                       "K1 bitwise kernel": same(got, mode)}
        if p == 256:
            ref, ref_lse = k1.slab_rope_attention_int8_ref(q, k, v, cos, sin,
                                                           **kw)
            top = float(ref.abs().max())
            full = sp.slab_attention_probe(q, k, v, variant="int8_full",
                                           **kw)
            prod = k1.slab_rope_attention(q, k, v, cos, sin, qk_int8=True,
                                          **kw)
            for name, (o_, l_) in (("int8_full", full), ("K10", prod)):
                e_ = (_max_err(o_, ref) / top, _max_err(l_, ref_lse))
                identity[p][f"{name} err"] = e_
                identity[p][f"{name} ok"] = (e_[0] <= K10_OUT_TOL
                                             and e_[1] <= K10_LSE_TOL)
            identity[p]["K10 bitwise int8_full"] = same(full, prod)
            identity[p]["K codes bitwise"] = same(
                sp.probe_quantize_k(k, n_heads=h, variant="int8_full"),
                k1.rope_quantize_k(k, cos, sin, n_heads=h))
            identity[p]["Q codes bitwise"] = same(
                sp.probe_quantize_q(q, n_heads=h, variant="int8_full"),
                k1.rope_quantize_q(q, cos, sin, n_heads=h))
    _probe_checks_hold(checks, f"B={b}")
    _check(all(all(ok for key, ok in r.items() if "err" not in key)
               for r in identity.values()),
           f"identity-table K1 / K10: {identity}")

    # the kernels line: kernel and int8_full at B=2, P=256, beside their
    # twins, SDPA and their bounds
    kw = dict(n_heads=h, tok_per_time=256)
    entries = {}
    for variant in ("kernel", "int8_full"):
        out, lse = sp.slab_attention_probe(q, k, v, variant=variant, **kw)
        ref, ref_lse = sp.TWINS[variant](q, k, v, **kw)
        entries[variant] = {
            "max_abs_err": max(_max_err(out, ref), _max_err(lse, ref_lse)),
            "ms": _time_ms(lambda: sp.slab_attention_probe(
                q, k, v, variant=variant, **kw)),
            "plain_ms": _time_ms(lambda: sp.TWINS[variant](q, k, v, **kw),
                                 iters=3),
            "library_ms": None, **_probe_bound(q, out, lse, 256, variant)}
    entries["kernel"]["library_ms"] = _time_ms(
        _sdpa(_heads(q, h), _heads(k, h), _heads(v, h),
              _slab_mask(t, 256, dev)), iters=3)

    # the probes' own entry points at the JAX tools' shape
    sp.launches = sp.launches_int8 = 0
    runs = {}
    for p in (8, 256):
        runs[p] = attn_probe.main([str(TIMING_REPEATS), "--block", str(p),
                                   "--batch", str(PROBE_BATCH)])
    runs["int8"] = int8_attr_probe.main([str(TIMING_REPEATS), "--batch",
                                         str(PROBE_BATCH)])
    launches = (sp.launches, sp.launches_int8)
    # every mode once more at the timed shape, on the CLIs' inputs: its
    # first rows against the same twins
    checks_b = _probe_checks(qb, kb, vb, h, twins)
    lb = torch.empty(PROBE_BATCH, h, t, device=dev)
    for key, res in runs.items():
        p = res["block"]
        for variant in res["variants"]:
            mode = "kernel" if variant == "bf16" else variant
            bound = _probe_bound(qb, qb, lb, p, variant)
            alone = (f", kernel alone {res[variant + '_kernel_ms']:.3f} ms"
                     if sp.is_int8(variant) else "")
            twin = " | ".join(
                f"B={rows} guard: finite {err[0]}, repeatable {err[1]}, max "
                f"|out - kernel's twin| {err[2]:.3e}" if variant == "no_kbd"
                else f"B={rows} vs twin: out {err[0]:.3e} of max |twin|, lse "
                f"{err[1]:.3e}"
                for rows, err in ((b, checks[(p, mode)]),
                                  (PROBE_BATCH, checks_b[(p, mode)])))
            lo, hi = res[f"{variant}_range_ms"]
            print(f"phase 19 probe {'int8_attr' if key == 'int8' else 'attn'}"
                  f" P={p} {variant}: B={PROBE_BATCH} T={t} H={h} D={d} "
                  f"{res[variant + '_ms']:.3f} ms ({lo:.3f}-{hi:.3f}){alone}"
                  f", issued {res[variant + '_issued_tflops']:.1f} TFLOP/s, "
                  f"useful {res[variant + '_useful_tflops']:.1f} TFLOP/s, "
                  f"bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}) "
                  f"| {twin} | {card}", flush=True)
    for p in (8, 256):
        r = runs[p]
        fwd = r["rope_ms"] - r["prep_ms"]
        print(f"phase 19 probe attn P={p} references: production K1 (rope) "
              f"{r['rope_ms']:.3f} ms, its rotation pre-pass alone "
              f"{r['prep_ms']:.3f} ms, K1 less its pre-pass {fwd:.3f} ms "
              f"(kernel {r['kernel_ms']:.3f} ms, "
              f"{r['kernel_ms'] / fwd:.3f}x), SDPA with the slab mask "
              f"{r['sdpa_ms']:.3f} ms, 4096^2 bf16 matmul "
              f"{r['matmul_tflops']:.1f} TFLOP/s; identity-table K1 against "
              f"kernel and its twin (tol {K1_TOL}), K10 against int8_full "
              f"and both against K10's twin (tol {K10_OUT_TOL} / "
              f"{K10_LSE_TOL}), their K and Q codes: {identity[p]}; "
              f"launches {launches[0]} bf16, {launches[1]} int8 | {card}",
              flush=True)
    r = runs["int8"]
    print(f"phase 19 probe int8_attr P=256 references: production K10 "
          f"{r['k10_ms']:.3f} ms, int8_full {r['int8_full_ms']:.3f} ms "
          f"({r['int8_full_ms'] / r['k10_ms']:.3f}x) | {card}", flush=True)
    occ = {(name, p): sp.occupancy(name, p) for p in (256, 8)
           for name in sp.PROBE_VARIANTS
           if name not in ("bf16", "mask_last", *sp.ALIASES)}
    occ.update({("K1 prep", 256): k1.fwd_occupancy("prep", d, 256),
                ("K10 Q prep", 256): k1.fwd_int8_occupancy("prep", d, 256)})
    print("phase 19 probe modes' forwards at D=32 (kernel and int8_full are "
          "production K1's and K10's), registers a thread / resident CTAs "
          "an SM: " + ", ".join(f"{name} P={p} {r}/{c}"
                                for (name, p), (r, c) in occ.items())
          + f" | {card}", flush=True)
    _probe_checks_hold(checks_b, f"B={PROBE_BATCH} (rows 0-{b - 1})")
    n_attn, n_int8 = len(attn_probe.VARIANTS), len(int8_attr_probe.VARIANTS)
    want = (2 * n_attn + 1, n_int8 - 1)    # bf16 is K1's kernel mode
    per_call = 1 + TIMING_REPEATS
    _check(launches == (want[0] * per_call, want[1] * 2 * per_call),
           f"probe launches {launches}, want {want} variants x {per_call} "
           "calls (int8 twice: with and without the pre-pass)")
    return {"launches": launches, "checks": checks,
            "checks_b": checks_b, "runs": runs,
            "occupancy": occ, **entries}


REST_STEPS = 20      # train steps of phase 20's FrankyLlama and SimpleMAE
REST_SESSIONS = 24   # session rows of phase 20's session-embedding step
_MAE_RUN: dict = {}  # phase 13's best MAE checkpoint, kept for phase 20


def _keep_mae_run(best) -> None:
    """Copy phase 13's best MAE checkpoint into a directory of its own,
    removed at exit, for phase 20's ``--init-encoder-from``."""
    import atexit
    import shutil
    import tempfile
    from pathlib import Path
    keep = Path(tempfile.mkdtemp(prefix="fk_mae_run_"))
    atexit.register(shutil.rmtree, keep, ignore_errors=True)
    shutil.copytree(best, keep / best.name)
    _MAE_RUN["dir"] = keep


def _run_record(run_dir) -> tuple:
    """(train losses, val losses, samples/s) logged in a run's
    metrics.jsonl."""
    records = [json.loads(line) for line in
               (run_dir / "metrics.jsonl").read_text().splitlines()]
    pick = lambda key: [r[key] for r in records if key in r]
    return pick("train/loss"), pick("val/loss"), pick("samples_per_sec")


def _check_run(state, losses, val, steps: int, what: str) -> None:
    _check(state.step == steps, f"{what} stopped at step {state.step}")
    _check(len(losses) >= 2 and all(map(math.isfinite, losses + val)),
           f"{what}: losses {losses}, val {val}")
    _check(losses[-1] < losses[0], f"{what}: loss did not fall: {losses}")


def _restores_bitwise(state, run_dir, fresh) -> str:
    """Load ``run_dir``'s best checkpoint into ``fresh`` (a new model of the
    same config) and its optimizer; raises unless parameters, AdamW state
    and step equal ``state``'s bitwise. Returns the checkpoint's name."""
    import torch
    from frankenstein_tpu_torch.train import checkpoints as ckpt_lib
    from frankenstein_tpu_torch.train import trainer
    best = ckpt_lib.best_checkpoint(run_dir)
    restored = ckpt_lib.restore_checkpoint(best, trainer.TrainState(
        fresh, trainer.make_optimizer(_train_config(run_dir), fresh)[0]))
    same = (restored.step == state.step and all(
        torch.equal(a, b) for a, b in zip(state.model.state_dict().values(),
                                          fresh.state_dict().values())))
    opt_a = state.optimizer.state_dict()["state"]
    opt_b = restored.optimizer.state_dict()["state"]
    same = same and all(torch.equal(opt_a[i][key], opt_b[i][key])
                        for i in opt_a for key in opt_a[i])
    _check(same, f"checkpoint {best.name} does not restore bitwise")
    return best.name


def _free_card() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _rest_franky_llama(card: str) -> dict:
    """FrankyLlama trained through the train CLI from its YAML, its encoder
    grafted from phase 13's MAE run."""
    import tempfile
    from pathlib import Path

    import torch
    from frankenstein_tpu_torch import submit
    from frankenstein_tpu_torch.models.franky import FrankyLlama
    from frankenstein_tpu_torch.train import __main__ as train_cli
    from frankenstein_tpu_torch.train import checkpoints as ckpt_lib
    from frankenstein_tpu_torch.train import trainer

    _check("dir" in _MAE_RUN,
           "phase 20 grafts phase 13's MAE run: run phase_mae first")
    mae = {k[len("encoder."):]: v for k, v in ckpt_lib.load_raw_checkpoint(
        _MAE_RUN["dir"])["model"].items() if k.startswith("encoder.")}
    repo = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        seen = {}
        real_run = trainer.run_train_model

        def snapshot(model, *a, **kw):
            seen.update({k: v.detach().cpu().clone() for k, v in
                         model.brain_model.encoder.state_dict().items()})
            return real_run(model, *a, **kw)

        trainer.run_train_model = snapshot
        _reset_launches()
        _reset_flash()
        t0 = time.perf_counter()
        try:
            state = train_cli.main([
                "--config", str(repo / "configs" / "franky_llama.yaml"),
                "--data", "synthetic", "--synthetic-trials", "256",
                "--steps", str(REST_STEPS), "--batch-size", "32",
                "--warmup", "5", "--eval-interval", str(REST_STEPS),
                "--init-encoder-from", str(_MAE_RUN["dir"]),
                "--exp-name", "fl", "--save-folder", tmp])
            torch.cuda.synchronize()
        finally:
            trainer.run_train_model = real_run
        run_s = time.perf_counter() - t0
        launches, flash = _read_launches(), _read_flash()
        run_dir = Path(tmp) / "fl"
        losses, val, rate = _run_record(run_dir)
        cfg = state.model.cfg
        _check(isinstance(state.model, FrankyLlama),
               f"franky_llama.yaml built {type(state.model).__name__}")
        _check_run(state, losses, val, REST_STEPS, "FrankyLlama")
        _check(set(seen) == set(mae) and all(
            torch.equal(seen[k], mae[k]) for k in seen),
            "FrankyLlama's encoder is not the MAE checkpoint's")
        # one eval batch: 32 validation trials at batch 32
        n, passes = cfg.brain.encoder.n_layers, REST_STEPS + 1
        want = dict.fromkeys(launches, 0)
        want.update(K1=n * passes, K4=n * REST_STEPS,
                    K9=_k9_blocks(cfg) * passes)
        _check(launches == want and not any(flash.values()),
               f"FrankyLlama launches {launches} {flash}, want {want}")
        ckpt = _restores_bitwise(state, run_dir, FrankyLlama(
            cfg, device=torch.device("cuda"), dtype=torch.bfloat16))
        _free_card()
        sub = submit.main(["--run-dir", str(run_dir), "--data", "synthetic",
                           "--synthetic-trials", "8", "--out",
                           str(Path(tmp) / "sub.txt")])
        lines = sub.read_text().splitlines()
        _check(len(lines) == 8, f"submission has {len(lines)} lines")
        tcfg = _train_config(run_dir)
        ds = train_cli.build_datasets("synthetic", 768, 256, 256)[0]
        t1 = time.perf_counter()
        grad_errs = _grad_check(state, tcfg, ds)
        grad_s = time.perf_counter() - t1
        timed = _in_turns({"step": _train_stepper(state, tcfg, ds, 32)})
    del state
    _free_card()
    worst = max(grad_errs, key=grad_errs.get)
    step = timed["step"]
    print(f"phase 20 FrankyLlama training: configs/franky_llama.yaml "
          f"(768x256 window, {n}-layer encoder, ~110M LLaMA, f32 params, "
          f"bf16 compute), {REST_STEPS} steps at B=32 through the train CLI "
          f"with --init-encoder-from phase 13's MAE run in {run_s:.1f} s: "
          f"encoder equal to the MAE checkpoint's bitwise before step 1, "
          f"train loss {losses[0]:.4f} -> {losses[-1]:.4f} (logged "
          f"{len(losses)}), val {val[-1]:.4f}, samples/s in the log "
          f"{rate[-1]:.1f}, launches {launches} (K1 = {n} and K9 = "
          f"{_k9_blocks(cfg)} per forward, K4 = {n} per step), checkpoint "
          f"{ckpt} restored bitwise, submit --run-dir wrote {len(lines)} "
          f"lines | B=1 card vs f32 CPU twin gradients ({grad_s:.1f} s): "
          f"global norm rel err {grad_errs['global_norm']:.3e}, worst "
          f"encoder attention weight {worst} {grad_errs[worst]:.3e} (tol "
          f"{GRAD_TOL}) | B=32 step {_note(step['ms'])} ms, "
          f"{32e3 / step['ms'][0]:.1f} samples/s at the median, peak "
          f"{step['gib']:.2f} GiB, median (range) of {TIMING_REPEATS} | "
          f"{card}", flush=True)
    _check(max(grad_errs.values()) <= GRAD_TOL,
           f"FrankyLlama card vs CPU gradients: {grad_errs}")
    return {"launches": launches, "step_ms": step["ms"],
            "peak_gib": step["gib"], "grad": grad_errs}


def _simple_mae_grads(model, x, idx, witness: bool = False) -> tuple:
    """Gradients of one SimpleMAE loss at B=1 with mask ``idx``: on the card
    (bf16 compute) and for the same weights as f32 on the CPU; their
    ``_grad_errs`` over every attention weight. With ``witness``, also the
    same weights' gradients from bf16 compute on the CPU against f32, each
    attention weight's relative error (what bf16 rounding alone gives),
    else an empty dict."""
    import torch
    from frankenstein_tpu_torch.models.simple_mae import SimpleMAE
    model.zero_grad(set_to_none=True)
    model(x.cuda().to(torch.bfloat16),
          indices=tuple(i.cuda() for i in idx))[0].backward()
    card = {n: p.grad.cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    weights = {k: v.cpu() for k, v in model.state_dict().items()}

    def cpu_grads(dtype):
        ref = SimpleMAE(model.enc_cfg, model.dec_cfg, dtype=dtype)
        ref.load_state_dict(weights)
        ref(x.to(dtype or torch.float32), indices=idx)[0].backward()
        return {n: p.grad for n, p in ref.named_parameters()}

    cpu = cpu_grads(None)
    attn = [n for n in cpu if ".attn." in n]
    low = {}
    if witness:
        low = _grad_errs(cpu_grads(torch.bfloat16), cpu, attn)
        del low["global_norm"]
    return _grad_errs(card, cpu, attn), low


def _rest_simple_mae(card: str) -> dict:
    """SimpleMAE trained through the train CLI by flags at 768 x 256."""
    import tempfile
    from pathlib import Path

    import torch
    from frankenstein_tpu_torch.models.brainformer import masking_indices
    from frankenstein_tpu_torch.models.simple_mae import SimpleMAE
    from frankenstein_tpu_torch.models.weights import init_simple_mae_
    from frankenstein_tpu_torch.ops import attention as tattn
    from frankenstein_tpu_torch.ops import masks as mask_lib
    from frankenstein_tpu_torch.ops.cuda import flash_attention as k67
    from frankenstein_tpu_torch.ops.cuda import fused_mlp as k9
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    from frankenstein_tpu_torch.train import __main__ as train_cli

    twins = [(k67, "flash_attention_ref"), (k67, "flash_attention_bwd_ref"),
             (k1, "slab_rope_attention_ref"),
             (k1, "slab_rope_attention_bwd_ref"),
             (k9, "fused_norm_swiglu_ref"), (tattn, "_softmax_av")]
    with tempfile.TemporaryDirectory() as tmp:
        _reset_launches()
        _reset_flash()
        t0 = time.perf_counter()
        with _CountCalls(twins) as plain:
            state = train_cli.main([
                "--model", "simple_mae", "--window", "768", "--channels",
                "256", "--data", "synthetic", "--synthetic-trials", "256",
                "--steps", str(REST_STEPS), "--batch-size", "32",
                "--warmup", "5", "--eval-interval", str(REST_STEPS),
                "--exp-name", "smae", "--save-folder", tmp])
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, flash = _read_launches(), _read_flash()
        run_dir = Path(tmp) / "smae"
        losses, val, rate = _run_record(run_dir)
        model = state.model
        enc, dec = model.enc_cfg, model.dec_cfg
        _check_run(state, losses, val, REST_STEPS, "SimpleMAE")
        ckpt = _restores_bitwise(state, run_dir, SimpleMAE(
            enc, dec, device=torch.device("cuda"), dtype=torch.bfloat16))

        ds = train_cli.build_datasets("synthetic", 768, 256, 256)[0]
        xb = torch.stack([torch.from_numpy(ds[i][0]) for i in range(32)])
        padded = int((~mask_lib.padding_mask(xb)).sum())
        streams = {}
        hooks = [blocks[0].register_forward_pre_hook(
            lambda m, a, key=key: streams.__setitem__(key, a[0].dtype))
            for key, blocks in (("encoder", model.encoder.transformer["h"]),
                                ("decoder", model.decoder["h"]))]
        with torch.no_grad():
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            loss_p, recon, binary = model(xb.cuda().to(torch.bfloat16),
                                          generator=gen, return_preds=True)
        for h in hooks:
            h.remove()
        # K9's gate takes a block whose stream is in the compute dtype: the
        # encoder's (bf16), not the decoder's, which is f32 because the mask
        # token takes the dtype of the encoder's ln_f output (f32 weights),
        # as in the JAX package
        _check(streams == {"encoder": torch.bfloat16,
                           "decoder": torch.float32},
               f"SimpleMAE residual streams {streams}, want a bf16 encoder "
               f"and an f32 decoder")
        k9_blocks = enc.n_layers
        passes = REST_STEPS + 1
        want = dict.fromkeys(launches, 0)
        want["K9"] = k9_blocks * passes
        softmax_want = (enc.n_layers + dec.n_layers) * passes
        calls = plain.calls
        _check(padded > 0, "no padded timestep in the B=32 windows")
        _check(launches == want and not any(flash.values()),
               f"SimpleMAE launches {launches} {flash}, want {want}")
        _check(calls.pop("attention._softmax_av") == softmax_want
               and not any(calls.values()),
               f"SimpleMAE plain calls {plain.calls}, want "
               f"{softmax_want} plain attentions and no twin")
        _check(recon.shape == binary.shape == xb.shape
               and math.isfinite(float(loss_p)),
               f"return_preds {tuple(recon.shape)}, loss {float(loss_p)}")

        # B=1 gradients with the same mask: at the seeded initial weights
        # every attention weight, after training the global norm
        i = next(i for i in range(len(ds)) if not ds[i][0][-1].any())
        x = torch.from_numpy(ds[i][0][None])
        idx = masking_indices(torch.Generator().manual_seed(SEED), 1, 768,
                              dec.masking_ratio)
        t1 = time.perf_counter()
        init = init_simple_mae_(SimpleMAE(enc, dec, device=torch.device(
            "cuda"), dtype=torch.bfloat16), seed=SEED)
        at_init, witness = _simple_mae_grads(init, x, idx, witness=True)
        del init
        trained = _simple_mae_grads(model, x, idx)[0]
        grad_s = time.perf_counter() - t1
        tcfg = _train_config(run_dir)
        ab = _k9_ab(_train_stepper(state, tcfg, ds, 32))
    del state, model
    _free_card()
    worst = max(at_init, key=at_init.get)
    w_worst = max(witness, key=witness.get)
    print(f"phase 20 SimpleMAE pretraining: --model simple_mae --window 768 "
          f"--channels 256 ({enc.block_size} timestep tokens of width "
          f"{enc.patch_size}, {int(enc.block_size * (1 - dec.masking_ratio))}"
          f" kept, {enc.n_layers}+{dec.n_layers} RMSNorm blocks of width "
          f"{enc.dim}, f32 params, bf16 compute), {REST_STEPS} steps at B=32 "
          f"through the train CLI in {run_s:.1f} s: train loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (logged {len(losses)}), val "
          f"{val[-1]:.4f}, samples/s in the log {rate[-1]:.1f}, {padded} "
          f"padded timesteps in 32 windows, streams encoder "
          f"{streams['encoder']} / decoder {streams['decoder']}, launches "
          f"{launches} (K9 RMSNorm = {k9_blocks} per forward), K6 / K7 0, "
          f"plain attentions {softmax_want} ({enc.n_layers + dec.n_layers} "
          f"per forward: the padding masks), twins 0, checkpoint {ckpt} "
          f"restored bitwise, return_preds {tuple(recon.shape)} | B=1 card "
          f"vs f32 CPU twin gradients, same mask, a padded window "
          f"({grad_s:.1f} s): at the seeded initial weights global norm rel "
          f"err {at_init['global_norm']:.3e}, worst attention weight {worst} "
          f"{at_init[worst]:.3e} (tol {GRAD_TOL}) where bf16 compute on the "
          f"CPU gives {witness[worst]:.3e}, bf16 CPU's worst {w_worst} "
          f"{witness[w_worst]:.3e}; after training global "
          f"norm {trained['global_norm']:.3e} | B=32 step in turns "
          f"{_ab_note(ab)}, {32e3 / ab[True]['ms'][0]:.1f} samples/s at the "
          f"K9-on median | {card}", flush=True)
    _check(max(at_init.values()) <= GRAD_TOL
           and trained["global_norm"] <= GRAD_TOL,
           f"SimpleMAE card vs CPU gradients: {at_init}, trained {trained}")
    return {"launches": launches, "k9_rmsnorm": want["K9"],
            "k9_per_forward": k9_blocks, "step_ab": ab, "grad": at_init,
            "witness": witness}


def _rest_brainformer(card: str) -> dict:
    """BrainFormer forward and backward at the train CLI's geometry against
    its f32 CPU twin; one Franky step with the session embedding."""
    import dataclasses

    import torch
    from frankenstein_tpu_torch.config import (FrankyConfig, MAEConfig,
                                               PerceiverConfig, TrainConfig)
    from frankenstein_tpu_torch.models.brainformer import BrainFormer
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.models.weights import (init_brainformer_,
                                                       init_franky_)
    from frankenstein_tpu_torch.train import __main__ as train_cli
    from frankenstein_tpu_torch.train import trainer
    from frankenstein_tpu_torch.train.schedule import make_lr_schedule

    b = 8
    ds = train_cli.build_datasets("synthetic", 768, 256, 64)[0]
    x = torch.stack([torch.from_numpy(ds[i][0]) for i in range(b)])
    # the JAX train.py's --model brainformer geometry (flags' defaults)
    cfg = PerceiverConfig(encoder=MAEConfig(window_size=768,
                                            n_electrodes=256, patch_size=32),
                          n_output_tokens=25, output_dim=50257)
    targets = torch.randn(b, cfg.n_output_tokens, cfg.output_dim,
                          generator=torch.Generator().manual_seed(SEED))
    model = init_brainformer_(BrainFormer(cfg, device=torch.device("cuda"),
                                          dtype=torch.bfloat16), seed=SEED)
    _reset_launches()
    loss, pred = model(x.cuda().to(torch.bfloat16), targets.cuda())
    loss.backward()
    torch.cuda.synchronize()
    launches = _read_launches()
    n = cfg.encoder.n_layers
    want = dict.fromkeys(launches, 0)
    want.update(K1=n, K4=n, K9=n + cfg.n_layers)
    _check(launches == want, f"BrainFormer launches {launches}, want {want}")
    card_grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
    ref = BrainFormer(cfg)
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    preds, cpu_loss = [], 0.0
    for i in range(b):     # the batch mean, one sample at a time
        li, pi = ref(x[i:i + 1], targets[i:i + 1])
        (li / b).backward()
        cpu_loss += float(li.detach()) / b
        preds.append(pi.detach())
    cpu_s = time.perf_counter() - t0
    cpu = dict(ref.named_parameters())
    names = [k for k in cpu if k.startswith("brain.encoder.")
             and ".attn." in k] + ["brain.perceiver.to_motion.weight"]
    errs = _grad_errs(card_grads, {k: p.grad for k, p in cpu.items()}, names)
    pred_rel = _max_err(pred.detach().cpu(), torch.cat(preds)) / float(
        torch.cat(preds).abs().max())
    loss_rel = abs(float(loss.detach()) - cpu_loss) / cpu_loss
    del ref, card_grads, cpu

    # a B=32 train step (AdamW, float targets), timed
    tcfg = TrainConfig(batch_size=32, warmup_iters=0, use_scheduler=False)
    state = trainer.TrainState(model, trainer.make_optimizer(tcfg, model)[0])
    ds32 = torch.stack([torch.from_numpy(ds[i][0]) for i in range(32)])
    batch = (ds32.cuda(), torch.randn(
        32, cfg.n_output_tokens, cfg.output_dim, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED)))
    sched, gen = make_lr_schedule(tcfg), torch.Generator(device="cuda")
    step = _in_turns({"step": lambda: trainer.train_step(
        state, batch, tcfg, sched, gen)})["step"]
    del state, model, batch
    _free_card()

    # one Franky training step with per-sample session rows
    fcfg = FrankyConfig()
    fcfg = dataclasses.replace(fcfg, brain=dataclasses.replace(
        fcfg.brain, encoder=dataclasses.replace(fcfg.brain.encoder,
                                                n_sessions=REST_SESSIONS)))
    franky = init_franky_(Franky(fcfg, device=torch.device("cuda"),
                                 dtype=torch.bfloat16), seed=SEED)
    tcfg = tcfg.replace(batch_size=2)
    state = trainer.TrainState(franky,
                               trainer.make_optimizer(tcfg, franky)[0])
    dates = torch.tensor([5, 6 + REST_SESSIONS], dtype=torch.int32)
    batch = (x[:2].cuda(), torch.stack([torch.from_numpy(ds[i][1])
                                        for i in range(2)]).cuda(),
             dates.cuda())
    _reset_launches()
    step_loss = float(trainer.loss_and_grads(state, batch, tcfg))
    step_launches = _read_launches()
    rows = franky.brain_model.encoder.date_embedding.grad.abs().sum(-1).cpu()
    used = sorted({int(d) % REST_SESSIONS for d in dates})
    trainer.apply_update(state, tcfg, make_lr_schedule(tcfg))
    del state, franky
    _free_card()
    print(f"phase 20 BrainFormer: the train CLI's --model brainformer "
          f"geometry (768x256 window, {n}-layer encoder, "
          f"{cfg.n_output_tokens} x {cfg.output_dim} outputs, f32 params, "
          f"bf16 compute), one forward and backward at B={b} with float "
          f"targets: launches {launches}, L1 loss {float(loss):.5f} vs f32 "
          f"CPU twin {cpu_loss:.5f} (rel {loss_rel:.3e}), pred max err "
          f"{pred_rel:.3e} of max |pred| (tol {SLICE_TOL}), gradients "
          f"({cpu_s:.1f} s on the CPU) global norm rel err "
          f"{errs['global_norm']:.3e}, worst of the encoder attention and "
          f"to_motion weights {max(errs.values()):.3e} (tol {GRAD_TOL}) | "
          f"B=32 train step (AdamW, float targets) {_note(step['ms'])} ms, "
          f"{32e3 / step['ms'][0]:.1f} samples/s at the median, peak "
          f"{step['gib']:.2f} GiB, median (range) of {TIMING_REPEATS} | "
          f"session embedding: one Franky step at B=2 with n_sessions="
          f"{REST_SESSIONS}, date_info {dates.tolist()}: loss "
          f"{step_loss:.4f}, launches {step_launches}, date_embedding rows "
          f"with a gradient {[r for r in range(REST_SESSIONS) if rows[r]]} "
          f"(want {used}) | {card}", flush=True)
    _check(pred_rel <= SLICE_TOL and loss_rel <= GRAD_TOL
           and max(errs.values()) <= GRAD_TOL,
           f"BrainFormer card vs CPU: pred {pred_rel}, loss {loss_rel}, "
           f"gradients {errs}")
    _check(math.isfinite(step_loss)
           and [r for r in range(REST_SESSIONS) if rows[r]] == used,
           f"session rows with a gradient: {rows.tolist()}, want {used}")
    return {"launches": launches, "grad": errs, "pred_rel": pred_rel,
            "step_ms": step["ms"], "peak_gib": step["gib"]}


def phase_rest(card: str) -> dict:
    """Phase 20: the remaining training paths (FrankyLlama, SimpleMAE,
    BrainFormer and the session embedding). Needs phase 13's MAE run."""
    return {"franky_llama": _rest_franky_llama(card),
            "simple_mae": _rest_simple_mae(card),
            "brainformer": _rest_brainformer(card)}


WHISPER_STEPS = 20      # phase 21's pipeline steps at B=16
WHISPER_TOKENS = 25     # tokens of phase 21's B=32 requests
WHISPER_TF_STEPS = 24   # teacher-forced decode steps of its CPU cross-check


def _whisper_logits(model, mel, toks) -> list:
    """f32 logits of ``model`` on its device: the prefill's, then one
    decode_step's for each column of ``toks`` (teacher-forced)."""
    import torch
    from frankenstein_tpu_torch.models import whisper
    dev = model.device
    prompt = model.sot_prompt()
    cache = whisper.init_whisper_cache(
        model.cfg, mel.shape[0], len(prompt) + toks.shape[1] + 2, device=dev)
    logits, cache, length = model.prefill(
        torch.tensor(prompt, device=dev).repeat(mel.shape[0], 1),
        mel.to(dev), cache)
    out = [logits.float().cpu()]
    for i in range(toks.shape[1]):
        logits, cache, length = model.decode_step(toks[:, i].to(dev), cache,
                                                  length)
        out.append(logits.float().cpu())
    return out


def _whisper_twin(model, dtype=None):
    """The same weights on the CPU, computing in ``dtype`` (f32 if None)."""
    from frankenstein_tpu_torch.models.whisper import BrainWhisper
    twin = BrainWhisper(model.cfg, dtype=dtype)
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return twin


def _whisper_cross_check(model, mel) -> dict:
    """The card's logits (bf16 compute) against the same weights as f32 on
    the CPU, prefill and WHISPER_TF_STEPS teacher-forced steps at B=2:
    "card" the largest error relative to max |f32 logits| over the steps,
    "witness" the same for bf16 compute on the CPU."""
    import torch
    toks = torch.randint(0, model.cfg.n_vocab - 3, (mel.shape[0],
                                                    WHISPER_TF_STEPS),
                         generator=torch.Generator().manual_seed(SEED))
    ref = _whisper_logits(_whisper_twin(model), mel, toks)
    rel = lambda got: max(_max_err(g, r) / float(r.abs().max())
                          for g, r in zip(got, ref))
    return {"card": rel(_whisper_logits(model, mel, toks)),
            "witness": rel(_whisper_logits(
                _whisper_twin(model, torch.bfloat16), mel, toks))}


def _whisper_grads(model, ds) -> tuple:
    """One B=1 loss's gradients on the card (bf16 compute) against the same
    weights as f32 on the CPU: ``_grad_errs`` over every attention
    projection, and the same for bf16 compute on the CPU (the witness)."""
    import torch
    x, y, _ = ds[0]
    x, y = torch.from_numpy(x[None]), torch.from_numpy(y[None])
    model.zero_grad(set_to_none=True)
    model(x.cuda().to(torch.bfloat16), y.cuda())[0].backward()
    card = {n: p.grad.cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)

    def cpu_grads(dtype):
        twin = _whisper_twin(model, dtype)
        twin(x.to(dtype or torch.float32), y)[0].backward()
        return {n: p.grad for n, p in twin.named_parameters()}

    cpu = cpu_grads(None)
    attn = [n for n in cpu if "_attn." in n and n.endswith("proj.weight")]
    low = _grad_errs(cpu_grads(torch.bfloat16), cpu, attn)
    return _grad_errs(card, cpu, attn), low


class _CrossBatches:
    """While installed, records the batch of every cross K/V and self-KV
    tensor that ``BrainWhisper.expand_cache`` returns and
    ``BrainWhisper.reorder_cache`` is given and returns."""

    def __init__(self):
        from frankenstein_tpu_torch.models.whisper import BrainWhisper
        self.cls, self.seen = BrainWhisper, []

    def _record(self, what, cache):
        self.seen.append((what, {c.shape[0] for kv in cache[2] for c in kv},
                          {k.shape[0] for k in cache[0]}))

    def __enter__(self):
        self.saved = {n: self.cls.__dict__[n]
                      for n in ("expand_cache", "reorder_cache")}
        expand = self.saved["expand_cache"].__func__
        reorder = self.saved["reorder_cache"].__func__

        def expand_rec(cache, w):
            out = expand(cache, w)
            self._record("expand", out)
            return out

        def reorder_rec(cache, flat_idx, group=0):
            self._record("reorder in", cache)
            out = reorder(cache, flat_idx, group=group)
            self._record("reorder out", out)
            return out

        self.cls.expand_cache = staticmethod(expand_rec)
        self.cls.reorder_cache = staticmethod(reorder_rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)


def _kernel_count(fn) -> int:
    """Device kernels one call of fn() runs (torch.profiler, after a
    warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if _device_us(e) > 0
               and not re.match(r"(Optimizer\.|ProfilerStep)", e.key))


def phase_whisper(card: str) -> dict:
    """Phase 21: the whisper path at whisper-tiny width (bf16 compute,
    seeded weights): the card against its CPU twins, B=32 greedy and
    beam-of-5 int8-KV requests, the seq2seq WER eval, and the fine-tuning
    pipeline. No kernel of the port lies on this path."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from frankenstein_tpu_torch import whisper_pipeline
    from frankenstein_tpu_torch.config import WhisperConfig
    from frankenstein_tpu_torch.data import tokenizers, whisper_prep
    from frankenstein_tpu_torch.decode import sampling
    from frankenstein_tpu_torch.eval.evaluate import evaluate_seq2seq_wer
    from frankenstein_tpu_torch.models import whisper
    from frankenstein_tpu_torch.models.weights import init_whisper_
    from frankenstein_tpu_torch.train import trainer

    _reset_launches()
    _reset_flash()
    cfg = WhisperConfig()
    model = init_whisper_(whisper.BrainWhisper(
        cfg, device=torch.device("cuda"), dtype=torch.bfloat16), seed=SEED)

    # 64 synthetic validation windows at full geometry, PCA fit on 128
    # train trials, on the card
    t0 = time.perf_counter()
    brains, _, val_brains, val_sentences = whisper_pipeline.load_trials(
        "synthetic", 128, 64)
    mean, comps = whisper_prep.fit_pca(brains, device="cuda")
    mels = whisper_prep.prepare_brain_data_for_whisper(
        val_brains, mean, comps, n_components=cfg.n_mels,
        pad_length=2 * cfg.n_audio_ctx, device="cuda")
    prep_s = time.perf_counter() - t0
    _check(mels.shape == (64, 80, 3000) and np.isfinite(mels).all(),
           f"whisper prep gave {mels.shape}")

    t0 = time.perf_counter()
    cross = _whisper_cross_check(model, torch.from_numpy(mels[:2]))
    cross_s = time.perf_counter() - t0

    b = 32
    x = torch.from_numpy(mels[:b]).cuda()
    prompt = model.sot_prompt()
    tok0 = torch.tensor(prompt, device="cuda").repeat(b, 1)

    def prefill():
        return model.prefill(tok0, x, whisper.init_whisper_cache(
            cfg, b, len(prompt) + WHISPER_TOKENS + 2, device="cuda"))

    state = prefill()
    greedy_toks = sampling.greedy_decode_scan(model, *state,
                                              max_new_tokens=WHISPER_TOKENS)
    _check(greedy_toks.shape == (b, WHISPER_TOKENS)
           and bool(torch.isfinite(state[0]).all())
           and int(greedy_toks.max()) < cfg.n_vocab,
           f"greedy request: tokens {tuple(greedy_toks.shape)}")
    greedy = _in_turns({
        "prefill": prefill,
        "decode": lambda: sampling.greedy_decode_scan(
            model, *state, max_new_tokens=WHISPER_TOKENS),
        "request": lambda: sampling.greedy_decode_scan(
            model, *prefill(), max_new_tokens=WHISPER_TOKENS)})
    profile = _profile_request(
        lambda: sampling.greedy_decode_scan(model, *prefill(),
                                            max_new_tokens=WHISPER_TOKENS),
        21, "whisper B=32 greedy request", "cuBLAS", card)
    step_kernels = _kernel_count(lambda: sampling.greedy_decode_scan(
        model, *state, max_new_tokens=WHISPER_TOKENS)) / (WHISPER_TOKENS - 1)

    def beam_request():
        logits, cache, length = prefill()
        return sampling.beam_from_prefill(
            model, logits, whisper.quantize_whisper_cache(cache), length,
            max_new_tokens=WHISPER_TOKENS, beam_width=5,
            eos_id=model.eot_id())

    with _CrossBatches() as batches:
        beam_toks, beam_scores = beam_request()
    _check(beam_toks.shape == (b, WHISPER_TOKENS)
           and bool(torch.isfinite(beam_scores).all()),
           f"beam request: tokens {tuple(beam_toks.shape)}")
    whats = [w for w, _, _ in batches.seen]
    _check(whats.count("expand") == 1
           and whats.count("reorder in") == WHISPER_TOKENS
           and all(c == {b} and s == {5 * b} for _, c, s in batches.seen),
           f"beam cache batches (what, cross, self): {batches.seen}")
    beams = _in_turns({"request": beam_request})

    tok = tokenizers.best_available_tokenizer()
    t0 = time.perf_counter()
    wer_g, preds_g = evaluate_seq2seq_wer(model, mels, val_sentences, tok,
                                          batch_size=b)
    wer_b, preds_b = evaluate_seq2seq_wer(model, mels, val_sentences, tok,
                                          batch_size=b, beam_width=5)
    eval_s = time.perf_counter() - t0
    _check(len(preds_g) == len(preds_b) == 64
           and math.isfinite(wer_g) and math.isfinite(wer_b),
           f"seq2seq WER {wer_g}, {wer_b}, predictions {len(preds_g)}, "
           f"{len(preds_b)}")
    del model, state, x
    _free_card()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pipe = whisper_pipeline.build(
            "synthetic", device=torch.device("cuda"), batch_size=16,
            steps=WHISPER_STEPS, eval_interval=WHISPER_STEPS)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = trainer.run_train_model(pipe.model, pipe.datasets,
                                        pipe.config, save_folder=Path(tmp),
                                        eval_metric=pipe.eval_metric)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_dir = Path(tmp) / pipe.config.exp_name
        losses, val, rate = _run_record(run_dir)
        records = [json.loads(line) for line in
                   (run_dir / "metrics.jsonl").read_text().splitlines()]
        wers = [r["val/metric"] for r in records if "val/metric" in r]
        _check_run(state, losses, val, WHISPER_STEPS, "whisper pipeline")
        _check(len(wers) == 1 and math.isfinite(wers[0]),
               f"whisper pipeline WER evals {wers}")
        ckpt = _restores_bitwise(state, run_dir, whisper.BrainWhisper(
            cfg, device=torch.device("cuda"), dtype=torch.bfloat16))
        ds = pipe.datasets[0]
        step = _in_turns({"step": _train_stepper(state, pipe.config, ds,
                                                 16)})["step"]
        t1 = time.perf_counter()
        grad_errs, witness = _whisper_grads(state.model, ds)
        grad_s = time.perf_counter() - t1
    del state, pipe
    _free_card()
    launches, flash = _read_launches(), _read_flash()

    g = {k: v["ms"] for k, v in greedy.items()}
    print(f"phase 21 whisper card vs CPU: whisper-tiny (80 x 3000 input, "
          f"4 + 4 layers of width 384, 6 heads, vocabulary {cfg.n_vocab}, "
          f"f32 params, bf16 compute, seeded weights), B=2, prefill and "
          f"{WHISPER_TF_STEPS} teacher-forced decode steps ({cross_s:.1f} "
          f"s): card vs f32 CPU twin max err {cross['card']:.3e} of max "
          f"|logits|, bf16 on the CPU {cross['witness']:.3e} (limit "
          f"{SLICE_TOL}); prep of 64 windows on the card (PCA-80 fit on 128 "
          f"trials, 2x FFT resample, pad to 3000) {prep_s:.1f} s | {card}",
          flush=True)
    print(f"phase 21 whisper B=32 greedy request ({WHISPER_TOKENS} tokens, "
          f"plain attention: the encoder's [32, 6, 1500, 1500] f32 scores): "
          f"prefill {_note(g['prefill'])} ms, decode {_note(g['decode'])} "
          f"ms, request {_note(g['request'])} ms, "
          f"{b * 1e3 / g['request'][0]:.1f} sentences/s at the median, peak "
          f"{greedy['request']['gib']:.2f} GiB, medians (range) of "
          f"{TIMING_REPEATS} in turns | beams of 5 over int8 self and cross "
          f"KV: request {_note(beams['request']['ms'])} ms, "
          f"{b * 1e3 / beams['request']['ms'][0]:.1f} sentences/s, peak "
          f"{beams['request']['gib']:.2f} GiB; cross K/V at batch {b} (self "
          f"KV {5 * b}) after expand_cache and all {WHISPER_TOKENS} "
          f"reorders | device busy {100 * sum(profile.values()) / g['request'][0]:.1f}% "
          f"of the median request; {step_kernels:.0f} kernels a greedy "
          f"decode step, {1e3 * g['decode'][0] / (WHISPER_TOKENS - 1) / step_kernels:.1f} "
          f"us of decode a kernel | {card}", flush=True)
    print(f"phase 21 whisper evaluate_seq2seq_wer over 64 synthetic windows "
          f"at B=32 ({eval_s:.1f} s): greedy WER {wer_g:.4f}, beams of 5 "
          f"WER {wer_b:.4f}, {len(preds_g)} and {len(preds_b)} predictions "
          f"(random weights) | {card}", flush=True)
    worst = max(grad_errs, key=grad_errs.get)
    print(f"phase 21 whisper pipeline: build (128 + 32 synthetic trials, "
          f"prep on the card) {build_s:.1f} s, {WHISPER_STEPS} steps at "
          f"B=16 with one WER eval in {run_s:.1f} s: train loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (logged {len(losses)}), val "
          f"{val[-1]:.4f}, WER {wers[0]:.4f}, samples/s in the log "
          f"{rate[-1]:.1f}, checkpoint {ckpt} restored bitwise | B=16 step "
          f"{_note(step['ms'])} ms, {16e3 / step['ms'][0]:.1f} samples/s at "
          f"the median, peak {step['gib']:.2f} GiB, median (range) of "
          f"{TIMING_REPEATS} | B=1 card vs f32 CPU twin gradients "
          f"({grad_s:.1f} s): global norm rel err "
          f"{grad_errs['global_norm']:.3e} (bf16 on the CPU "
          f"{witness['global_norm']:.3e}), worst attention projection "
          f"{worst} {grad_errs[worst]:.3e} where bf16 on the CPU gives "
          f"{witness[worst]:.3e} (tol {GRAD_TOL}) | launches {launches} "
          f"{flash} | {card}", flush=True)
    _check(cross["card"] <= SLICE_TOL,
           f"whisper card vs CPU logits: {cross}")
    _check(max(grad_errs.values()) <= GRAD_TOL,
           f"whisper card vs CPU gradients: {grad_errs}, bf16 CPU {witness}")
    _check(not any(launches.values()) and not any(flash.values()),
           f"phase 21 launched a kernel: {launches} {flash}")
    return {"greedy": greedy, "beams": beams, "step": step,
            "cross": cross, "grad": grad_errs, "wer": (wer_g, wer_b)}


VQ_STEPS = 30          # phase 22's VQ-VAE train steps at B=64
VQ_WARMUP = 5          # warm-up steps: the YAML's lr (1e-3) from step 5 on
VQ_EVAL = 10           # steps between evals of the (fixed) validation set
VQ_BATCH = 64          # the reference notebook's batch
VQ_TIE = 2e-2          # cosine gap between a row's two best codes (f32 on
                       # the CPU) under which bf16 may pick either
VQ_WINDOWS = 4         # B=1 card-vs-CPU steps, one a window with padding
# card (bf16 convs) vs f32 CPU twin, relative, at B=1: between the largest
# sound reading (card or bf16 CPU: loss 1.8e-4, rec_loss 1.1e-4,
# commit_loss 2.4e-3) and the smallest under the faults _vq_faults
# injects (loss 5.2e-4, rec_loss 5.9e-2, commit_loss 1.8e-2; PERF.md)
VQ_LOSS_TOL = {"loss": 3e-4, "rec_loss": 1e-3, "commit_loss": 6e-3}
VQ_COMMIT_FAULT = 1.02  # the commitment-weight fault: 2% too large
STREAM_T = 4096        # phase 22's synthetic recording, time bins
STREAM_STRIDE = 8      # stream_predict's defaults
STREAM_BATCH = 8


def _vq_tie_rows(model, x) -> tuple:
    """(f32 CPU indices [N], near-tie mask [N]) of ``model``'s encoder
    output on ``x``: a row whose two best codes' cosine similarities lie
    within VQ_TIE of each other may flip under bf16."""
    import torch
    from frankenstein_tpu_torch.ops.vq import l2norm
    with torch.no_grad():
        e = model.encoder(x).reshape(-1, model.cfg.D).float()
        sim = l2norm(e) @ l2norm(model.quantizer._codebook.embed).T
    top2 = torch.topk(sim, 2, dim=-1).values
    return torch.argmax(sim, -1), (top2[:, 0] - top2[:, 1]) < VQ_TIE


def _vq_terms(model) -> dict:
    """The loss and its two terms of ``model``'s last forward."""
    rec, commit = (float(model.aux[k]) for k in ("rec_loss", "commit_loss"))
    return {"loss": rec + commit, "rec_loss": rec, "commit_loss": commit}


def _vq_step(model, x) -> tuple:
    """One train-mode forward and backward of a SoundStream (no draws:
    initted, threshold 0): (loss terms, {name: grad}, codebook after, the
    indices the step assigned)."""
    idx = model.get_quantize_vectors(x)[0].reshape(-1)
    model.zero_grad(set_to_none=True)
    loss, _ = model(x, train=True)
    loss.backward()
    return (_vq_terms(model), {n: p.grad.detach().float().cpu()
                               for n, p in model.named_parameters()},
            model.quantizer._codebook.embed.detach().float().cpu().clone(),
            idx.cpu())


def _rel_terms(got: dict, want: dict) -> dict:
    return {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}


def _vq_errs(got: tuple, want: tuple, ties, before) -> dict:
    """Relative errors of a ``_vq_step`` against the f32 CPU twin's: the
    loss and its terms, the global gradient norm, the worst conv weight,
    and the codebook's update at the codes no flipped or near-tie row
    touched."""
    import torch
    errs = _grad_errs(got[1], want[1], [n for n in want[1]
                                        if n.endswith("weight")])
    worst = max((n for n in errs if n.endswith("weight")), key=errs.get)
    flipped = (got[3] != want[3]) | ties
    bad = torch.zeros(before.shape[0], dtype=torch.bool)
    bad[want[3][flipped]] = True
    bad[got[3][flipped]] = True
    keep = ~bad
    upd = (want[2] - before)[keep]
    return {**_rel_terms(got[0], want[0]),
            "global_norm": errs["global_norm"], "worst": (worst, errs[worst]),
            "codebook": float((got[2] - want[2])[keep].norm() / upd.norm())}


def _vq_faults(twin, cfg0, x, want: dict) -> dict:
    """The loss terms' relative errors on the card (bf16 convs) against the
    f32 CPU twin's ``want`` under three injected faults: the commitment
    weight 2% too large, padded rows counted in the L1, and the codebook
    held in bf16."""
    import torch
    from frankenstein_tpu_torch.models import vq_brain

    def terms(model):
        with torch.no_grad():
            model(x)
        return _rel_terms(_vq_terms(model), want)

    out = {"commit x1.02": terms(twin("cuda", torch.bfloat16, cfg0.replace(
        commitment_weight=cfg0.commitment_weight * VQ_COMMIT_FAULT)))}
    sound_l1 = vq_brain.masked_l1_loss
    vq_brain.masked_l1_loss = lambda pred, gt: torch.mean(
        torch.abs(pred.float() - gt.float()))
    try:
        out["padding counted"] = terms(twin("cuda", torch.bfloat16, cfg0))
    finally:
        vq_brain.masked_l1_loss = sound_l1
    model = twin("cuda", torch.bfloat16, cfg0)
    book = model.quantizer._codebook
    book.embed.copy_(book.embed.to(torch.bfloat16).float())
    out["codebook in bf16"] = terms(model)
    return out


def _vq_card_vs_cpu(state, cfg, ds) -> dict:
    """Phase 22's B=1 check: the trained model written as a reference file
    by the port's writer, read back (``soundstream_state``: an imported,
    initted codebook) with ``threshold_ema_dead_code=0`` so the step draws
    nothing, one train step on the card (bf16 convs) against an f32 CPU
    twin, on VQ_WINDOWS windows with padded rows, with bf16 on the CPU and
    f32 on the card beside it; then the loss terms under ``_vq_faults``."""
    import tempfile
    from pathlib import Path

    import torch
    from frankenstein_tpu_torch.models import import_reference as ir
    from frankenstein_tpu_torch.models.vq_brain import SoundStream
    from frankenstein_tpu_torch.models.weights import load_strict

    cfg0 = cfg.replace(threshold_ema_dead_code=0.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "soundstream.safetensors"
        ir.save_state_dict(state.model.state_dict(), path)
        sd = ir.soundstream_state(ir.load_state_dict(path))

    def twin(device, dtype, c=cfg0):
        return load_strict(SoundStream(c, device=torch.device(device),
                                       dtype=dtype), sd)

    before = sd["quantizer._codebook.embed"].float()
    padded = [i for i in range(len(ds)) if not ds[i][0][-1].any()]
    runs = {"card": [], "card_f32": [], "witness": [], "faults": []}
    ties_n = rows = 0
    for i in padded[:VQ_WINDOWS]:
        x = torch.from_numpy(ds[i][0][None])
        cpu = _vq_step(twin("cpu", None), x)
        _, ties = _vq_tie_rows(twin("cpu", None), x)
        ties_n, rows = ties_n + int(ties.sum()), rows + ties.numel()
        for key, device, dtype in (("card", "cuda", torch.bfloat16),
                                   ("card_f32", "cuda", None),
                                   ("witness", "cpu", torch.bfloat16)):
            got = _vq_step(twin(device, dtype), x.to(device).to(
                dtype or torch.float32))
            runs[key].append(_vq_errs(got, cpu, ties, before))
        runs["faults"].append(_vq_faults(
            twin, cfg0, x.cuda().to(torch.bfloat16), cpu[0]))
    worst = {key: {k: max(r[k] for r in runs[key])
                   for k in ("loss", "rec_loss", "commit_loss",
                             "global_norm", "codebook")}
             for key in ("card", "card_f32", "witness")}
    for key in worst:
        worst[key]["worst"] = max((r["worst"] for r in runs[key]),
                                  key=lambda w: w[1])
    faults = {name: {k: min(f[name][k] for f in runs["faults"])
                     for k in VQ_LOSS_TOL} for name in runs["faults"][0]}
    return {**worst, "faults": faults, "ties": ties_n, "rows": rows,
            "windows": len(runs["card"])}


def _vq_within_limits(check: dict) -> bool:
    """The card's loss terms under VQ_LOSS_TOL, which the faults' terms
    exceed (the commitment fault on the loss and commit_loss, counting
    padding on the loss and rec_loss; the bf16 codebook moves them less
    than bf16 itself does, and is reported only); its gradients and codebook update
    within WITNESS_FACTOR of bf16 on the CPU's, or under GRAD_TOL."""
    card, wit, faults = check["card"], check["witness"], check["faults"]
    sound = all(card[k] <= tol for k, tol in VQ_LOSS_TOL.items())
    caught = all(faults["commit x1.02"][k] > VQ_LOSS_TOL[k]
                 for k in ("loss", "commit_loss")) and all(
        faults["padding counted"][k] > VQ_LOSS_TOL[k]
        for k in ("loss", "rec_loss"))
    pairs = [(card[k], wit[k]) for k in ("global_norm", "codebook")]
    pairs.append((card["worst"][1], wit["worst"][1]))
    return sound and caught and all(
        c <= max(GRAD_TOL, WITNESS_FACTOR * w) for c, w in pairs)


def _vq_refresh(model, ds) -> dict:
    """One train-mode forward of a copy of the trained VQ-VAE on the card
    at B=64 with the YAML's threshold: each code the EMA leaves under the
    threshold must hold the l2norm of a row of the batch's encoder output
    at cluster size 1, and every other code the EMA update, recomputed
    here by ``index_add_`` and ``bincount``."""
    import torch
    from frankenstein_tpu_torch.models.vq_brain import SoundStream
    from frankenstein_tpu_torch.ops.vq import l2norm
    c = model.cfg
    copy = SoundStream(c, device=torch.device("cuda"), dtype=torch.bfloat16)
    copy.load_state_dict(model.state_dict())
    book = copy.quantizer._codebook
    x = _batches(ds, VQ_BATCH, 1)[0][0].to(torch.bfloat16)
    with torch.no_grad():
        rows = copy.encoder(x).reshape(-1, c.D).float()
        cb, cs = book.embed.clone(), book.cluster_size.clone()
        idx = torch.argmax(l2norm(rows) @ l2norm(cb).T, -1)
        counts = torch.bincount(idx, minlength=c.codebook_size).float()
        sums = torch.zeros_like(cb).index_add_(0, idx, rows)
        upd = torch.where(counts[:, None] > 0,
                          l2norm(sums / counts.clamp_min(1.0)[:, None]), cb)
        want_cb = cb * c.ema_decay + upd * (1 - c.ema_decay)
        want_cs = cs * c.ema_decay + counts * (1 - c.ema_decay)
        dead = want_cs < c.threshold_ema_dead_code
        copy(x, train=True,
             generator=torch.Generator(device="cuda").manual_seed(SEED))
        got = book.embed
        unit = l2norm(rows)
        pick = torch.argmax(got[dead] @ unit.T, -1)
        keep = ~dead
        return {"dead": int(dead.sum()), "codes": c.codebook_size,
                "rows": int(rows.shape[0]),
                "distinct_rows": int(torch.unique(pick).numel()),
                "row_err": float((got[dead] - unit[pick]).abs().max())
                if dead.any() else 0.0,
                "size_one": bool((book.cluster_size[dead] == 1.0).all()),
                "ema_err": float((got[keep] - want_cb[keep]).norm()
                                 / (want_cb[keep] - cb[keep]).norm()),
                "size_err": float((book.cluster_size[keep]
                                   - want_cs[keep]).abs().max()),
                "avg_err": float((book.embed_avg - got * book.cluster_size[
                    :, None]).abs().max()),
                "initted": float(book.initted)}


def _vq_tokens(model, ds) -> dict:
    """``get_quantize_vectors`` of 4 windows on the card (bf16) against
    the f32 CPU twin's indices, off near-ties."""
    import numpy as np
    import torch
    from frankenstein_tpu_torch.models.vq_brain import SoundStream
    x = torch.from_numpy(np.stack(ds.inputs[:4]))
    ref = SoundStream(model.cfg)
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want, ties = _vq_tie_rows(ref, x)
    idx, quantized = model.get_quantize_vectors(
        x.cuda().to(torch.bfloat16))
    got = idx.reshape(-1).cpu()
    off = ~ties
    return {"rows": int(got.numel()), "ties": int(ties.sum()),
            "differ_off_ties": int((got[off] != want[off]).sum()),
            "differ_at_ties": int((got[ties] != want[ties]).sum()),
            "shape": tuple(quantized.shape)}


def _vq_first_step(cfg, tcfg, ds) -> dict:
    """A fresh CLI model (``kmeans_init``: initted 0) through one train step
    at B=64 on the card: k-means from the batch, the EMA update and the
    dead-code refresh, then initted 1."""
    import torch
    from frankenstein_tpu_torch.models.vq_brain import SoundStream
    from frankenstein_tpu_torch.models.weights import init_soundstream_
    from frankenstein_tpu_torch.train import trainer
    from frankenstein_tpu_torch.train.schedule import make_lr_schedule
    model = init_soundstream_(SoundStream(
        cfg, device=torch.device("cuda"), dtype=torch.bfloat16), seed=SEED)
    state = trainer.TrainState(model, trainer.make_optimizer(tcfg, model)[0])
    book = model.quantizer._codebook
    before = float(book.initted)
    loss, aux = trainer.train_step(state, _batches(ds, VQ_BATCH, 1)[0], tcfg,
                                   make_lr_schedule(tcfg),
                                   torch.Generator(device="cuda"))
    return {"before": before, "after": float(book.initted),
            "loss": float(loss), "perplexity": float(aux["perplexity"]),
            "refreshed": int((book.cluster_size == 1.0).sum())}


def _means(values, n: int = 10) -> list:
    """Means of consecutive runs of ``n`` values."""
    return [sum(values[i:i + n]) / len(values[i:i + n])
            for i in range(0, len(values), n)]


def _vq_train(card: str) -> dict:
    """Phase 22 (a): configs/vqvae.yaml through the train CLI at the YAML's
    lr after a VQ_WARMUP-step warm-up (its own 2000 would hold the lr under
    2e-5 for all VQ_STEPS), logging every step and evaluating every
    VQ_EVAL: 512 synthetic trials, so the validation set (64) fills one
    batch."""
    import tempfile
    from pathlib import Path

    import torch
    import yaml
    from frankenstein_tpu_torch.models.vq_brain import SoundStream
    from frankenstein_tpu_torch.train import __main__ as train_cli
    from frankenstein_tpu_torch.utils import profiling

    repo = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        doc = yaml.safe_load((repo / "configs" / "vqvae.yaml").read_text())
        doc["train"]["log_interval"] = 1
        config = Path(tmp) / "vqvae.yaml"
        config.write_text(yaml.safe_dump(doc))
        _reset_launches()
        t0 = time.perf_counter()
        state = train_cli.main([
            "--config", str(config), "--data", "synthetic",
            "--synthetic-trials", "512", "--steps", str(VQ_STEPS),
            "--batch-size", str(VQ_BATCH), "--warmup", str(VQ_WARMUP),
            "--eval-interval", str(VQ_EVAL), "--exp-name", "smoke_vq",
            "--save-folder", tmp])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _read_launches()
        run_dir = Path(tmp) / "smoke_vq"
        logged = [json.loads(line) for line in
                  (run_dir / "metrics.jsonl").read_text().splitlines()]
        train_logs = [r for r in logged if "train/loss" in r]
        losses, val, rate = _run_record(run_dir)
        _check(state.step == VQ_STEPS and len(losses) == VQ_STEPS
               and len(val) == VQ_STEPS // VQ_EVAL
               and all(map(math.isfinite, losses + val)),
               f"VQ-VAE: step {state.step}, losses {losses}, val {val}")
        keys = ("perplexity", "rec_loss", "commit_loss", "mfu")
        _check(all(k in train_logs[-1] for k in keys)
               and all(math.isfinite(train_logs[-1][k]) for k in keys),
               f"VQ-VAE metrics.jsonl lacks {keys}: {train_logs[-1]}")
        _check(not any(launches.values()),
               f"the VQ-VAE launched a kernel: {launches}")
        model = state.model
        cfg = model.cfg
        _check(float(model.quantizer._codebook.initted) == 1.0,
               "initted is not set after training")
        best = _restores_bitwise(state, run_dir, SoundStream(
            cfg, device=torch.device("cuda"), dtype=torch.bfloat16))
        tcfg = _train_config(run_dir)
        ds = train_cli.build_datasets("synthetic", 768, cfg.n_electrodes,
                                      256)[0]
        first = _vq_first_step(cfg, tcfg, ds)
        _check(first["before"] == 0.0 and first["after"] == 1.0
               and math.isfinite(first["loss"]),
               f"first VQ-VAE step: {first}")
        refresh = _vq_refresh(model, ds)
        t0 = time.perf_counter()
        check = _vq_card_vs_cpu(state, cfg, ds)
        check_s = time.perf_counter() - t0
        tokens = _vq_tokens(model, ds)
        step = _in_turns({"step": _train_stepper(state, tcfg, ds,
                                                 VQ_BATCH)})["step"]
        big_ms, big_peak = _time_steps(state, tcfg.replace(batch_size=256),
                                       ds, 256, 1)
        prof = _profile_steps(state, tcfg, ds, "VQ-VAE", card,
                              batch_size=VQ_BATCH, phase=22)
    flops = profiling.vqvae_fwd_flops_per_sample(cfg, t=768)
    peak = profiling.detect_peak_flops()
    mfu = 3 * flops * VQ_BATCH / (step["ms"][0] / 1e3) / peak
    per = {k: _means([r[k] for r in train_logs], VQ_EVAL)
           for k in ("train/loss", "rec_loss", "commit_loss", "grad_norm")}
    fmt = lambda xs: " / ".join(f"{v:.4f}" for v in xs)
    print(f"phase 22 VQ-VAE: configs/vqvae.yaml (768 x {cfg.n_electrodes}, "
          f"C={cfg.C}, D={cfg.D}, K={cfg.codebook_size}, strides "
          f"{cfg.strides}; f32 params, bf16 convs, f32 quantizer), "
          f"{VQ_STEPS} steps at B={VQ_BATCH} through the train CLI at lr "
          f"{tcfg.learning_rate:g} after {VQ_WARMUP} warm-up steps in "
          f"{run_s:.1f} s: per step loss "
          f"{' '.join(f'{v:.4f}' for v in losses)} | means of {VQ_EVAL} "
          f"steps: loss {fmt(per['train/loss'])}, rec_loss "
          f"{fmt(per['rec_loss'])}, commit_loss {fmt(per['commit_loss'])}"
          f", grad_norm {fmt(per['grad_norm'])} | val every {VQ_EVAL}: "
          f"{fmt(val)} | last log perplexity "
          f"{train_logs[-1]['perplexity']:.1f} mfu "
          f"{train_logs[-1]['mfu']:.4f}, samples/s in the log {rate[-1]:.1f}"
          f", launches {launches}, checkpoint {best} restored bitwise "
          f"(codebook buffers included) | fresh model's first step: initted "
          f"{first['before']:.0f} -> {first['after']:.0f}, perplexity "
          f"{first['perplexity']:.1f}, {first['refreshed']} of "
          f"{cfg.codebook_size} codes at cluster size 1 (refreshed or "
          f"k-means counts of 1) | {card}", flush=True)
    r = refresh
    print(f"phase 22 VQ-VAE refresh on the card (trained model, B="
          f"{VQ_BATCH}, threshold {cfg.threshold_ema_dead_code:g}): "
          f"{r['dead']} of {r['codes']} codes dead after the EMA, each "
          f"refreshed with a row of the batch's {r['rows']} ({r['distinct_rows']}"
          f" distinct), max |code - l2norm(row)| {r['row_err']:.3e}, all "
          f"at cluster size 1: {r['size_one']} | the other codes vs the EMA "
          f"recomputed by index_add_: {r['ema_err']:.3e} of the update, "
          f"cluster sizes {r['size_err']:.3e} | max |embed_avg - embed x "
          f"size| {r['avg_err']:.3e}, initted {r['initted']:.0f} | {card}",
          flush=True)
    c, w, f32 = check["card"], check["witness"], check["card_f32"]
    terms = lambda d: ", ".join(f"{k} {d[k]:.3e}" for k in VQ_LOSS_TOL)
    print(f"phase 22 VQ-VAE B=1 steps on an imported initted codebook, "
          f"threshold 0, {check['windows']} windows with padded rows "
          f"({check_s:.1f} s), largest relative error against the f32 CPU "
          f"twin: card bf16 {terms(c)}; bf16 on the CPU {terms(w)}; card "
          f"f32 {terms(f32)} | limits {terms(VQ_LOSS_TOL)} | smallest "
          f"under each fault on the card: "
          + "; ".join(f"{name} {terms(v)}"
                      for name, v in check["faults"].items())
          + f" | gradient global norm {c['global_norm']:.3e} (bf16 CPU "
          f"{w['global_norm']:.3e}, card f32 {f32['global_norm']:.3e}), "
          f"worst conv weight {c['worst'][0]} {c['worst'][1]:.3e} "
          f"({w['worst'][0]} {w['worst'][1]:.3e}), codebook update "
          f"{c['codebook']:.3e} ({w['codebook']:.3e}) over the codes no "
          f"flipped or near-tie row touched ({check['ties']} of "
          f"{check['rows']} rows near a tie) | get_quantize_vectors at "
          f"B=4: {tokens['rows']} rows, "
          f"{tokens['differ_off_ties']} differ off near-ties, "
          f"{tokens['differ_at_ties']} of {tokens['ties']} near-ties "
          f"differ | B={VQ_BATCH} step {_note(step['ms'])} ms, "
          f"{VQ_BATCH * 1e3 / step['ms'][0]:.1f} samples/s at the median, "
          f"MFU {mfu:.4f} ({flops / 1e9:.3f} GFLOP a sample forward, x3), "
          f"peak {step['gib']:.2f} GiB, median (range) of {TIMING_REPEATS}"
          f" | B=256 step {big_ms:.1f} ms, peak {big_peak:.2f} GiB | "
          f"{card}", flush=True)
    _check(all(b < a for a, b in zip(val, val[1:]))
           and per["train/loss"][-1] < per["train/loss"][0],
           f"VQ-VAE loss did not fall: val {val}, means {per}")
    _check(r["dead"] > 0 and r["size_one"] and r["row_err"] <= 1e-6
           and r["ema_err"] <= 1e-4 and r["size_err"] <= 1e-6
           and r["avg_err"] <= 1e-5 and r["initted"] == 1.0,
           f"VQ-VAE refresh on the card: {r}")
    _check(_vq_within_limits(check),
           f"VQ-VAE card vs CPU beyond its limits: {check}")
    _check(tokens["differ_off_ties"] == 0,
           f"get_quantize_vectors differs off near-ties: {tokens}")
    return {"step": step, "big_ms": big_ms, "check": check,
            "refresh": refresh, "tokens": tokens, "mfu": mfu,
            "profile": prof}


def _stream_signal():
    import numpy as np
    rng = np.random.default_rng(SEED)
    return rng.standard_normal((STREAM_T, 256)).astype(np.float32)


def _vq_stream(card: str) -> dict:
    """Phase 22 (b): the flagship Franky over a long recording through
    ``stream_predict``."""
    import torch
    from frankenstein_tpu_torch.decode import streaming
    model = _flagship()
    signal = _stream_signal()
    window = model.cfg.brain.encoder.window_size
    n_windows = (STREAM_T - window) // STREAM_STRIDE + 1
    calls = -(-n_windows // STREAM_BATCH)
    run = lambda: streaming.stream_predict(
        model, signal, window_size=window, stride=STREAM_STRIDE,
        batch_windows=STREAM_BATCH)
    _reset_launches()
    outs = run()
    torch.cuda.synchronize()
    launches = _read_launches()
    n_blocks = model.cfg.brain.encoder.n_layers
    _check(len(outs) == n_windows
           and launches["K1"] == n_blocks * calls
           and launches["K9"] == _k9_blocks(model.cfg) * calls
           and launches["K4"] == launches["K10"] == launches["K2"] == 0,
           f"streaming: {len(outs)} windows, launches {launches}")
    ms = _time_each_ms(run, iters=3)
    worst = 0.0
    with torch.no_grad():
        for i, out in enumerate(outs):
            start = i * STREAM_STRIDE
            direct = model.encode(torch.from_numpy(
                signal[start:start + window][None]).cuda())[0]
            worst = max(worst, _max_err(out, direct)
                        / float(direct.float().abs().max()))
    med = _spread(ms)
    print(f"phase 22 streaming: the flagship Franky (random weights, bf16) "
          f"over a {STREAM_T} x 256 synthetic recording, window {window}, "
          f"stride {STREAM_STRIDE}, {STREAM_BATCH} windows a call: "
          f"{n_windows} windows in {calls} encode calls, launches K1 "
          f"{launches['K1']} = {n_blocks} x {calls}, K9 {launches['K9']} = "
          f"{_k9_blocks(model.cfg)} x {calls} | each window's prefix vs a "
          f"direct B=1 encode: max err {worst:.3e} of max |prefix| (tol "
          f"{SLICE_TOL}) | {_note(med)} ms a recording, "
          f"{n_windows * 1e3 / med[0]:.1f} windows/s at the median of 3 | "
          f"{card}", flush=True)
    _check(worst <= SLICE_TOL, f"streamed vs direct encode: {worst}")
    return {"launches": launches, "ms": med, "windows": n_windows,
            "model": model}


def _vq_profiling(card: str, model) -> dict:
    """Phase 22 (c): this card's peaks and a trace of one encode."""
    import json
    import tempfile
    from pathlib import Path

    import torch
    from frankenstein_tpu_torch.utils import profiling
    peak, bw = profiling.detect_peak_flops(), profiling.detect_hbm_bw()
    name = torch.cuda.get_device_name()
    _check(peak is not None and bw is not None,
           f"utils/profiling.py knows no peak for {name}")
    x = torch.from_numpy(_stream_signal()[None, :768]).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            with torch.no_grad():
                model.encode(x)
            torch.cuda.synchronize()
        trace = Path(tmp) / "trace.json"
        events = json.loads(trace.read_text()).get("traceEvents", [])
        size = trace.stat().st_size
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = sum("slab_rope_attn_fwd" in e.get("name", "") for e in kernels)
    print(f"phase 22 profiling: detect_peak_flops() {peak:.4g} FLOP/s, "
          f"detect_hbm_bw() {bw:.4g} B/s for {name}; trace() of one B=1 "
          f"encode wrote {size} bytes, {len(events)} events, "
          f"{len(kernels)} kernels ({k1} of K1) | {card}", flush=True)
    _check(size > 0 and kernels and k1 > 0,
           f"trace: {size} bytes, {len(kernels)} kernels, {k1} K1")
    return {"peak": peak, "bw": bw}


def _vq_reference_files(card: str, model) -> dict:
    """Phase 22 (d): the flagship's weights as a reference .safetensors
    (the port's writer), through convert_reference, served by ``submit
    --checkpoint``; then written back with --reverse."""
    import tempfile
    from pathlib import Path

    import torch
    from frankenstein_tpu_torch import convert_reference, submit
    from frankenstein_tpu_torch.models import import_reference as ir
    from frankenstein_tpu_torch.train import checkpoints as ckpt_lib
    sd = {k: v.float().cpu() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ir.save_state_dict(sd, tmp / "franky.safetensors")
        size = (tmp / "franky.safetensors").stat().st_size
        t0 = time.perf_counter()
        ckpt = convert_reference.main([
            "--kind", "franky", "--src", str(tmp / "franky.safetensors"),
            "--dst", str(tmp / "run")])
        convert_s = time.perf_counter() - t0
        loaded = ckpt_lib.load_raw_checkpoint(ckpt)["model"]
        same = loaded.keys() == sd.keys() and all(
            torch.equal(loaded[k], sd[k]) for k in sd)
        _check(same, "the converted checkpoint differs from the file")
        t0 = time.perf_counter()
        out = submit.main(["--checkpoint", str(ckpt), "--data", "synthetic",
                           "--synthetic-trials", "8", "--out",
                           str(tmp / "sub.txt")])
        submit_s = time.perf_counter() - t0
        lines = out.read_text().splitlines()
        convert_reference.main(["--kind", "franky", "--reverse", "--src",
                                str(tmp / "run"), "--dst",
                                str(tmp / "back.safetensors")])
        back = ir.load_state_dict(tmp / "back.safetensors")
        round_trip = back.keys() == sd.keys() and all(
            torch.equal(back[k], sd[k]) for k in sd)
    print(f"phase 22 reference files: the flagship's {len(sd)} tensors "
          f"as a {size / 2 ** 20:.1f} MiB .safetensors (the port's writer) "
          f"-> convert_reference --kind franky in {convert_s:.1f} s "
          f"({ckpt.name}, bitwise the file) -> submit --checkpoint wrote "
          f"{len(lines)} lines in {submit_s:.1f} s; --reverse wrote the "
          f"file back bitwise: {round_trip} | {card}", flush=True)
    _check(len(lines) == 8 and round_trip,
           f"reference files: {len(lines)} lines, round trip {round_trip}")
    return {"lines": len(lines)}


def phase_vq(card: str) -> dict:
    """Phase 22: the VQ-VAE trained at full width, streaming, profiling and
    the reference-file converter."""
    train = _vq_train(card)
    _free_card()
    stream = _vq_stream(card)
    prof = _vq_profiling(card, stream["model"])
    files = _vq_reference_files(card, stream.pop("model"))
    _free_card()
    return {"train": train, "stream": stream, "profiling": prof,
            "files": files}


MOE_STEPS = 30
MOE_BATCH = 32
MOE_WINDOWS = 4       # phase 23 (c): prefixes checked card against CPU
MOE_DDP_STEPS = 3     # phase 23 (d)
MOE_DDP_TOL = 1e-5    # a one-rank DDP / FSDP step's loss vs the unwrapped
MOE_ROUTE_SLACK = 5e-2  # the card's route agreement may fall this far
                        # under bf16 on the CPU's
VQ_DDP_BUFFERS = ("embed", "cluster_size", "embed_avg", "initted")


def _moe_routes(model, run) -> tuple:
    """(``run()``'s result, each MoE layer's top-k experts of every token
    [N, K]) from a forward pre-hook on every MoESwiGLU of ``model``."""
    from frankenstein_tpu_torch.models.moe import MoESwiGLU, stable_topk
    routes, hooks = [], []

    def grab(mod, args):
        x = args[0].reshape(-1, mod.dim).to(mod.compute_dtype
                                            or mod.w1.dtype)
        probs = (x.float() @ mod.wg.float()).softmax(-1)
        routes.append(stable_topk(probs, mod.k)[1].cpu())

    for mod in model.modules():
        if isinstance(mod, MoESwiGLU):
            hooks.append(mod.register_forward_pre_hook(grab))
    try:
        return run(), routes
    finally:
        for h in hooks:
            h.remove()


def _pinned(run, routes):
    """``run()`` with every MoE layer call taking the next of ``routes``
    (the twin's expert choices [N, K], in call order) instead of its own
    top-k, its gates the probabilities of those experts:
    ``models.moe.stable_topk`` patched for the call only."""
    from frankenstein_tpu_torch.models import moe
    todo = list(routes)
    real = moe.stable_topk

    def take(probs, k):
        idx = todo.pop(0).to(probs.device)
        return probs.gather(-1, idx), idx

    moe.stable_topk = take
    try:
        out = run()
    finally:
        moe.stable_topk = real
    _check(not todo, f"{len(todo)} pinned routes left over")
    return out


def _moe_card_vs_cpu(model, prefixes, texts) -> dict:
    """The trained MoE GPT (``model.llm_model``, bf16 compute on the card)
    on each window's prefix and text (its pad ids) at B=1, teacher-forced,
    against its f32 CPU twin, and
    bf16 on the CPU as the witness: the worst logits error relative to max
    |twin| and the share of routes (token, layer) whose set of top-k
    experts equals the twin's; then the same errors with every route
    pinned to the twin's (``_pinned``), where bf16 flips none."""
    import copy

    import torch
    lm = model.llm_model
    twin = copy.deepcopy(lm).cpu().float()
    for mod in twin.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = None
    witness = copy.deepcopy(twin)
    for mod in witness.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.bfloat16
    errs = {"card": 0.0, "witness": 0.0}
    pinned = {"card": 0.0, "witness": 0.0}
    agree = {"card": [0, 0], "witness": [0, 0]}
    with torch.no_grad():
        for prefix, idx in zip(prefixes, texts):
            p, i = prefix.float().cpu(), idx.cpu()
            want, r_want = _moe_routes(twin, lambda: twin(i, p, i)[1])
            for name, m, dev in (("card", lm, "cuda"),
                                 ("witness", witness, "cpu")):
                got, r_got = _moe_routes(
                    m, lambda: m(i.to(dev), p.to(dev), i.to(dev))[1])
                errs[name] = max(errs[name], _max_err(got.cpu(), want)
                                 / float(want.abs().max()))
                for a, b in zip(r_got, r_want):
                    same = a.sort(-1).values == b.sort(-1).values
                    agree[name][0] += int(same.all(-1).sum())
                    agree[name][1] += a.shape[0]
                got = _pinned(lambda: m(i.to(dev), p.to(dev), i.to(dev))[1],
                              r_want)
                pinned[name] = max(pinned[name], _max_err(got.cpu(), want)
                                   / float(want.abs().max()))
    return {"errs": errs, "pinned": pinned,
            "agree": {k: v[0] / max(v[1], 1) for k, v in agree.items()}}


def _moe_one_rank(card: str) -> dict:
    """Phase 23 (d): a one-rank NCCL group; MOE_DDP_STEPS f32 steps of the
    MoE Franky through the trainer's DDP and then its FSDP path, each
    against the same steps of an unwrapped copy."""
    import copy
    import tempfile
    from pathlib import Path

    import torch
    import torch.distributed as dist
    import yaml
    from frankenstein_tpu_torch.config import FrankyConfig, TrainConfig
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.models.weights import init_franky_
    from frankenstein_tpu_torch.train import __main__ as train_cli
    from frankenstein_tpu_torch.train import trainer

    repo = Path(__file__).resolve().parent
    doc = yaml.safe_load((repo / "configs" / "moe_gpt.yaml").read_text())
    cfg = FrankyConfig.from_dict(doc["model_config"])
    cfg = cfg.replace(brain=cfg.brain.replace(
        encoder=cfg.brain.encoder.replace(window_size=96)))
    ds = train_cli.build_datasets("synthetic", 96, 256, 64)[0]
    batches = _batches(ds, 4, MOE_DDP_STEPS)
    dev = torch.device("cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                rank=0, world_size=1)
        try:
            for mode in ("ddp", "fsdp"):
                model = init_franky_(Franky(cfg, device=dev), seed=SEED)
                ref = copy.deepcopy(model)
                tcfg = TrainConfig(batch_size=4, learning_rate=1e-4,
                                   warmup_iters=0, use_scheduler=False,
                                   mixed_precision=False, mesh_shape=(1, 1),
                                   fsdp=mode == "fsdp")
                runs = {}
                for name, m, par in (("wrapped", model, True),
                                     ("plain", ref, False)):
                    p = (trainer.setup_parallel(m, tcfg, dev) if par
                         else None)
                    opt, sched = trainer.make_optimizer(tcfg, m)
                    state = trainer.TrainState(m, opt, parallel=p)
                    gen = torch.Generator(device=dev)
                    runs[name] = [float(trainer.train_step(
                        state, b, tcfg, sched, gen)[0]) for b in batches]
                    runs[name + "_kind"] = type(p.runner).__name__ if p \
                        else "none"
                rel = max(abs(a - b) / abs(b) for a, b in
                          zip(runs["wrapped"], runs["plain"]))
                out[mode] = {"rel": rel, "losses": runs["wrapped"],
                             "runner": runs["wrapped_kind"],
                             "sharded": sum(hasattr(q, "placements")
                                            for q in model.parameters())}
                del model, ref, state, opt
                _free_card()
            out["vq"] = _vq_one_rank(dev)
        finally:
            dist.destroy_process_group()
    return out


def _vq_one_rank(dev) -> dict:
    """Phase 23 (d), the VQ-VAE: MOE_DDP_STEPS f32 steps at B=64 of a fresh
    SoundStream at phase 22's geometry (``configs/vqvae.yaml``: k-means on
    the first step, then the EMA and the refresh) through the trainer's DDP
    path against an unwrapped copy: each loss, and the four codebook
    buffers after the steps, relative to max |unwrapped|. cuDNN runs its
    deterministic algorithms here, so the two runs differ only where DDP
    makes them differ."""
    import copy
    from pathlib import Path

    import torch
    import yaml
    from frankenstein_tpu_torch.config import TrainConfig, VQVAEConfig
    from frankenstein_tpu_torch.models.vq_brain import SoundStream
    from frankenstein_tpu_torch.models.weights import init_soundstream_
    from frankenstein_tpu_torch.train import __main__ as train_cli
    from frankenstein_tpu_torch.train import trainer

    repo = Path(__file__).resolve().parent
    doc = yaml.safe_load((repo / "configs" / "vqvae.yaml").read_text())
    cfg = VQVAEConfig.from_dict(doc["model_config"])
    ds = train_cli.build_datasets("synthetic", 768, cfg.n_electrodes,
                                  MOE_DDP_STEPS * VQ_BATCH)[0]
    batches = _batches(ds, VQ_BATCH, MOE_DDP_STEPS)
    tcfg = TrainConfig(batch_size=VQ_BATCH, learning_rate=1e-3,
                       warmup_iters=0, use_scheduler=False,
                       mixed_precision=False, mesh_shape=(1, 1))
    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        model = init_soundstream_(SoundStream(cfg, device=dev), seed=SEED)
        ref = copy.deepcopy(model)
        runs = {}
        for name, m, par in (("wrapped", model, True), ("plain", ref, False)):
            p = trainer.setup_parallel(m, tcfg, dev) if par else None
            opt, sched = trainer.make_optimizer(tcfg, m)
            state = trainer.TrainState(m, opt, parallel=p)
            gen = torch.Generator(device=dev)
            before = float(m.quantizer._codebook.initted)
            runs[name] = [float(trainer.train_step(
                state, b, tcfg, sched, gen)[0]) for b in batches]
            runs[name + "_kind"] = type(p.runner).__name__ if p else "none"
            runs[name + "_initted"] = (before, float(
                m.quantizer._codebook.initted))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
    books = [m.quantizer._codebook for m in (model, ref)]
    buffers = {n: _max_err(getattr(books[0], n), getattr(books[1], n))
               / max(float(getattr(books[1], n).abs().max()), 1e-12)
               for n in VQ_DDP_BUFFERS}
    out = {"rel": max(abs(a - b) / abs(b) for a, b in
                      zip(runs["wrapped"], runs["plain"])),
           "losses": runs["wrapped"], "plain": runs["plain"],
           "runner": runs["wrapped_kind"], "buffers": buffers,
           "initted": runs["wrapped_initted"],
           "refreshed": int((books[1].cluster_size == 1.0).sum()),
           "geometry": f"768 x {cfg.n_electrodes}, C={cfg.C}, D={cfg.D}, "
                       f"K={cfg.codebook_size}"}
    del model, ref, state, opt, batches
    _free_card()
    return out


def phase_moe(card: str) -> dict:
    """Phase 23: the moe-gpt path trained and served on the card, its MoE
    GPT against the CPU, the one-rank NCCL DDP / FSDP steps and the
    dryrun."""
    import tempfile
    from pathlib import Path

    import torch
    import yaml
    from frankenstein_tpu_torch import submit
    from frankenstein_tpu_torch.data.tokenizers import (
        best_available_tokenizer)
    from frankenstein_tpu_torch.decode import pipeline
    from frankenstein_tpu_torch.dryrun import dryrun
    from frankenstein_tpu_torch.train import __main__ as train_cli

    repo = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        doc = yaml.safe_load((repo / "configs" / "moe_gpt.yaml").read_text())
        doc["train"]["log_interval"] = 1
        config = Path(tmp) / "moe_gpt.yaml"
        config.write_text(yaml.safe_dump(doc))
        _reset_launches()
        t0 = time.perf_counter()
        state = train_cli.main([
            "--config", str(config), "--mesh", "1,1", "--data", "synthetic",
            "--synthetic-trials", "256", "--steps", str(MOE_STEPS),
            "--batch-size", str(MOE_BATCH), "--warmup", "5",
            "--eval-interval", str(MOE_STEPS), "--exp-name", "smoke_moe",
            "--save-folder", tmp])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _read_launches()
        run_dir = Path(tmp) / "smoke_moe"
        losses, val, rate = _run_record(run_dir)
        cfg = state.model.cfg
        n_layers = cfg.brain.encoder.n_layers
        means = _means(losses, 10)
        _check(state.step == MOE_STEPS and len(losses) == MOE_STEPS
               and all(map(math.isfinite, losses + val))
               and means[-1] < means[0],
               f"moe-gpt: step {state.step}, losses {losses}, val {val}")
        # one eval batch: the 32 validation trials at batch 32
        _check(launches["K4"] == n_layers * MOE_STEPS
               and launches["K1"] == n_layers * (MOE_STEPS + 1)
               and launches["K9"] == _k9_blocks(cfg) * (MOE_STEPS + 1)
               and launches["K2"] == launches["K3"] == launches["K5"] == 0,
               f"moe-gpt training launches {launches}")
        tcfg = _train_config(run_dir)
        n_params = sum(p.numel() for p in state.model.parameters())
        n_expert = sum(p.numel() for n, p in state.model.named_parameters()
                       if ".moe.w" in n)
        ds = train_cli.build_datasets("synthetic", 768, 256, 256)[0]
        step = _in_turns({"step": _train_stepper(state, tcfg, ds,
                                                 MOE_BATCH)})["step"]

        # (c) before the run's weights are cast for serving
        xs = [torch.from_numpy(ds[i][0][None]).cuda()
              for i in range(MOE_WINDOWS)]
        texts = [state.model._padded(torch.from_numpy(ds[i][1][None]))
                 for i in range(MOE_WINDOWS)]
        with torch.no_grad():
            prefixes = [state.model.encode(x) for x in xs]
        check = _moe_card_vs_cpu(state.model, prefixes, texts)
        del state
        _free_card()

        t0 = time.perf_counter()
        sub = submit.main(["--run-dir", str(run_dir), "--data", "synthetic",
                           "--synthetic-trials", str(MOE_BATCH),
                           "--batch-size", str(MOE_BATCH), "--beam-width",
                           "5", "--out", str(Path(tmp) / "sub.txt")])
        submit_s = time.perf_counter() - t0
        lines = sub.read_text().splitlines()
        _check(len(lines) == MOE_BATCH, f"submission: {len(lines)} lines")
        cls, mcfg, best = submit.build_from_run_dir(run_dir)
        from frankenstein_tpu_torch.train import checkpoints as ckpt_lib
        model = cls(mcfg, device=torch.device("cuda"))
        model.load_state_dict(ckpt_lib.load_raw_checkpoint(
            best, map_location="cuda")["model"])
        model = pipeline.cast_params_for_inference(model)
        tok = best_available_tokenizer()
        predict = pipeline.make_franky_predictor(
            model, tok, max_new_tokens=mcfg.max_tokens, beam_width=5)
        batch = torch.stack([torch.from_numpy(ds[i][0])
                             for i in range(MOE_BATCH)]).numpy()
        _reset_launches()
        predict(batch)
        torch.cuda.synchronize()
        req_launches = _read_launches()
        _check(req_launches["K3"] == mcfg.max_tokens
               and req_launches["K1"] == n_layers
               and req_launches["K9"] == _k9_blocks(mcfg)
               and req_launches["K2"] == req_launches["K2-int8"] == 0,
               f"moe-gpt request launches {req_launches}")
        request = _in_turns({"request": lambda: predict(batch)})["request"]
        try:
            pipeline.make_franky_predictor(model, tok, beam_width=5,
                                           int8_weights=True)
            refused = False
        except NotImplementedError:
            refused = True
        _check(refused, "an MoE predictor took int8 weights")
        del model, predict
        _free_card()
    one_rank = _moe_one_rank(card)
    t0 = time.perf_counter()
    dry = dryrun(4, "cpu", timeout=300.0)
    dry_s = time.perf_counter() - t0
    oks = [line for line in dry.splitlines() if " ok, loss=" in line]
    _check(len(oks) == 7, f"dryrun: {dry}")
    agree = check["agree"]
    print(f"phase 23 moe-gpt: configs/moe_gpt.yaml (flagship encoder and "
          f"Perceiver, GPT-2 124M with a top-{cfg.gpt.moe_k} MoE of "
          f"{cfg.gpt.moe_experts} experts, hidden {4 * cfg.gpt.n_embd}, "
          f"capacity {cfg.gpt.moe_capacity}, aux weight "
          f"{cfg.gpt.moe_aux_weight}; {n_params / 1e6:.1f}M parameters, "
          f"{n_expert / 1e6:.1f}M of them experts; f32 params, bf16 "
          f"compute) trained {MOE_STEPS} steps at B={MOE_BATCH} through the "
          f"train CLI with --mesh 1,1 in {run_s:.1f} s: loss means of 10 "
          f"{' / '.join(f'{v:.4f}' for v in means)}, val {val[-1]:.4f}, "
          f"launches {launches} (K1 = {n_layers} and K9 = "
          f"{_k9_blocks(cfg)} a forward, K4 = {n_layers} a step) | B=32 "
          f"step {_note(step['ms'])} ms (median, range of {TIMING_REPEATS}),"
          f" {MOE_BATCH * 1e3 / step['ms'][0]:.1f} samples/s, peak "
          f"{step['gib']:.2f} GiB | {card}", flush=True)
    print(f"phase 23 moe-gpt served: submit --run-dir over {MOE_BATCH} "
          f"windows, beams of 5, in {submit_s:.1f} s ({len(lines)} lines) | "
          f"one B={MOE_BATCH} beam-of-5 request (bf16 weights): launches "
          f"{req_launches} (K3 = {mcfg.max_tokens}, K1 = {n_layers}, K9 = "
          f"{_k9_blocks(mcfg)}), {_note(request['ms'])} ms (median, range of"
          f" {TIMING_REPEATS}), peak {request['gib']:.2f} GiB; "
          f"int8_weights=True refused | {card}", flush=True)
    pin = check["pinned"]
    pin_limit = WITNESS_FACTOR * pin["witness"]
    print(f"phase 23 moe-gpt card vs CPU: the trained MoE GPT on "
          f"{MOE_WINDOWS} windows' prefixes at B=1: logits max err "
          f"{check['errs']['card']:.3e} of max |f32 CPU twin| (bf16 on the "
          f"CPU {check['errs']['witness']:.3e}; limit the larger of "
          f"{SLICE_TOL} and {WITNESS_FACTOR}x that); routes whose "
          f"{cfg.gpt.moe_k} experts are the twin's: card "
          f"{100 * agree['card']:.2f}%, bf16 on the CPU "
          f"{100 * agree['witness']:.2f}% | every route pinned to the "
          f"twin's: logits max err card {pin['card']:.3e}, bf16 on the CPU "
          f"{pin['witness']:.3e}, limit {pin_limit:.3e} ({WITNESS_FACTOR}x "
          f"bf16 on the CPU) | {card}", flush=True)
    print(f"phase 23 one-rank NCCL: {MOE_DDP_STEPS} f32 steps of the MoE "
          f"Franky (96 x 256 window) at B=4: DDP "
          f"({one_rank['ddp']['runner']}) losses "
          f"{' '.join(f'{v:.6f}' for v in one_rank['ddp']['losses'])}, max "
          f"rel err vs unwrapped {one_rank['ddp']['rel']:.2e}; FSDP2 "
          f"({one_rank['fsdp']['sharded']} DTensor parameters) losses "
          f"{' '.join(f'{v:.6f}' for v in one_rank['fsdp']['losses'])}, max "
          f"rel err {one_rank['fsdp']['rel']:.2e} (tol {MOE_DDP_TOL}) | "
          f"{card}", flush=True)
    vq = one_rank["vq"]
    print(f"phase 23 one-rank NCCL VQ-VAE: {MOE_DDP_STEPS} f32 steps of a "
          f"fresh SoundStream ({vq['geometry']}) at B={VQ_BATCH}, cuDNN "
          f"deterministic, initted {vq['initted'][0]:g} -> "
          f"{vq['initted'][1]:g} (k-means on step 1), {vq['refreshed']} "
          f"codes refreshed on the last: DDP ({vq['runner']}) losses "
          f"{' '.join(f'{v:.6f}' for v in vq['losses'])}, unwrapped "
          f"{' '.join(f'{v:.6f}' for v in vq['plain'])}, max rel err "
          f"{vq['rel']:.2e}; codebook buffers' rel err " + ", ".join(
              f"{n} {e:.2e}" for n, e in vq["buffers"].items()) +
          f" (tol {MOE_DDP_TOL}) | {card}", flush=True)
    print(f"phase 23 dryrun (4 gloo ranks on the CPU, {dry_s:.1f} s): "
          + " | ".join(line.split(": ", 1)[1] for line in oks), flush=True)
    _check(check["errs"]["card"] <= max(
               SLICE_TOL, WITNESS_FACTOR * check["errs"]["witness"])
           and agree["card"] >= agree["witness"] - MOE_ROUTE_SLACK,
           f"moe-gpt card vs CPU: {check}")
    _check(pin["card"] <= pin_limit,
           f"moe-gpt card vs CPU with pinned routes: {pin}")
    _check(one_rank["ddp"]["rel"] <= MOE_DDP_TOL
           and one_rank["fsdp"]["rel"] <= MOE_DDP_TOL
           and one_rank["ddp"]["runner"] == "DistributedDataParallel"
           and one_rank["fsdp"]["sharded"] > 0,
           f"one-rank NCCL steps: {one_rank}")
    _check(vq["rel"] <= MOE_DDP_TOL
           and max(vq["buffers"].values()) <= MOE_DDP_TOL
           and vq["runner"] == "DistributedDataParallel"
           and vq["initted"] == (0.0, 1.0),
           f"one-rank NCCL VQ-VAE steps: {vq}")
    return {"launches": launches, "request": req_launches, "step": step}


def _route_chain(h, gate, bias, k, ends_sum):
    """The PyTorch chain the route kernel replaces (the layer's route
    before it): scores, top k, weights, sort by expert, offsets, count."""
    import torch
    scores = torch.sigmoid(h.float() @ gate.float().t())
    chosen = torch.topk(scores + bias.float(), k, dim=-1).indices
    weights = torch.gather(scores, -1, chosen)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    experts, order = torch.sort(chosen.reshape(-1), stable=True)
    ends = torch.searchsorted(
        experts, torch.arange(gate.shape[0], device=h.device), right=True,
        out_int32=True)
    ends_sum += ends
    return order, weights


def _combine_chain(y, order, weights):
    """The PyTorch chain the combine kernel replaces: the unsort by
    ``index_copy_``, the weights' cast and ``bmm``."""
    import torch
    n, k = weights.shape
    y = torch.empty_like(y).index_copy_(0, order, y).view(n, k, -1)
    return torch.bmm(weights.to(y.dtype)[:, None], y)


def _graph_ms(fn, calls: int = 20) -> float:
    """Device ms of one call of ``fn`` inside a CUDA graph of ``calls``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _time_ms(graph.replay) / calls


def _routed_launches(card: str) -> dict:
    """The route and combine kernels' launches on the cell's own path: an
    LFM2 of full width (dim 2048, 32 experts, top 4, bf16) cut to its
    first 4 layers (2 routed), random weights from SEED. The prefill of
    160 rows x 33 positions and a decode step of 160 rows replayed from
    its CUDA graph (``StepGraphs``), each counted from zero: one route and
    one combine launch a routed layer."""
    import dataclasses
    import torch
    from frankenstein_tpu_torch.config import Lfm2MoeConfig
    from frankenstein_tpu_torch.models.lfm2 import Lfm2
    from frankenstein_tpu_torch.ops.cuda import moe_route as mr
    dev = torch.device("cuda")
    full = Lfm2MoeConfig()
    cfg = dataclasses.replace(full, num_hidden_layers=4,
                              layer_types=full.layer_types[:4])
    routed = cfg.num_hidden_layers - cfg.num_dense_layers
    model = Lfm2(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
    model = model.to(torch.bfloat16).eval()
    b, t = 160, 33
    hist = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                         device=dev)
    prefix = torch.randn(b, t - 1, cfg.hidden_size, generator=gen,
                         device=dev)
    tok = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=dev)
    counts = {}
    mr.launches = mr.combine_launches = 0
    _, cache, length = model.prefill(hist, prefix,
                                     model.init_decode_cache(b, t + 1))
    counts["prefill"] = (mr.launches, mr.combine_launches)
    _, cache, _ = model.decode_step(tok, cache, length)   # the capture
    mr.launches = mr.combine_launches = 0
    model.decode_step(tok, cache, length)
    torch.cuda.synchronize()
    counts["step"] = (mr.launches, mr.combine_launches)
    print(f"phase 24 moe_route launches on the path: LFM2 at full width cut "
          f"to {cfg.num_hidden_layers} layers ({routed} routed), bf16 | "
          f"prefill of {b} x {t} rows: route {counts['prefill'][0]}, "
          f"combine {counts['prefill'][1]} | a decode step of {b} rows "
          f"replayed from its CUDA graph: route {counts['step'][0]}, "
          f"combine {counts['step'][1]} | {card}", flush=True)
    _check(counts["prefill"] == counts["step"] == (routed, routed),
           f"moe_route launches, {routed} routed layers: {counts}")
    del model, cache
    _free_card()
    return {"routed": routed, "layers": cfg.num_hidden_layers, **counts}


def phase_moe_route(card: str) -> dict:
    """Phase 24: the route and combine kernels at the LFM2 cell's shapes,
    against their twins and the PyTorch chain they replace, and their
    launches on the cell's own path (``_routed_launches``)."""
    import torch
    from frankenstein_tpu_torch.ops.cuda import moe_route as mr
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d, e, k = 2048, 32, 4
    out = {}
    arrived = mr.arrival_count(dev)
    for n in (160, 160 * 33):
        h = torch.randn(n, d, generator=gen, device=dev)
        gate = (torch.randn(e, d, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        bias = (torch.randn(e, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        y = torch.randn(n * k, d, generator=gen, device=dev).to(
            torch.bfloat16)
        total = torch.zeros(e, dtype=torch.int64, device=dev)
        r = mr.route(h, gate, bias, k, arrived=arrived, ends_sum=total)
        got = mr.combine(y, r.weights, r.pos)
        torch.cuda.synchronize()
        # the twin on cuBLAS's scores: the kernel sums in another order,
        # so its choices are held to the rows whose top k + 1 picks lie
        # apart by more than that can move them
        want = mr.route_ref(h, gate, bias, k)
        top = (mr.scores_ref(h, gate) + bias.float()).sort(
            -1, descending=True).values[:, :k + 1]
        clear = (top[:, :-1] - top[:, 1:]).min(-1).values > 1e-5
        share = float(clear.float().mean())
        ends, rows, pos = mr.sort_ref(r.chosen, e)
        sort_exact = (torch.equal(r.ends, ends) and torch.equal(r.rows, rows)
                      and torch.equal(r.pos, pos)
                      and torch.equal(total, ends.long()))
        chosen_exact = torch.equal(r.chosen[clear], want.chosen[clear])
        w_err = float(((r.weights[clear] - want.weights[clear]).abs()
                       / want.weights[clear].abs()).max())
        comb = mr.combine_ref(y, r.weights, r.pos)
        room = torch.maximum(got.float().abs(), comb.float().abs()) / 128
        within = bool(((got.float() - comb.float()).abs() <= room).all())
        order = torch.sort(r.chosen.reshape(-1).long(), stable=True).indices
        fns = {
            "route": lambda: mr.route(h, gate, bias, k, arrived=arrived,
                                      ends_sum=total),
            "route twin": lambda: mr.route_ref(h, gate, bias, k),
            "route chain": lambda: _route_chain(h, gate, bias, k, total),
            "combine": lambda: mr.combine(y, r.weights, r.pos),
            "combine twin": lambda: mr.combine_ref(y, r.weights, r.pos),
            "combine chain": lambda: _combine_chain(y, order, r.weights)}
        ms = {name: _time_ms(fn) for name, fn in fns.items()}
        graph = {name: _graph_ms(fns[name]) for name in (
            "route", "route chain", "combine", "combine chain")}
        bounds = {"route": _bound(_nbytes(h, gate, bias) + 16 * n * k
                                  + 12 * e, 0),
                  "combine": _bound(_nbytes(y, got) + 8 * n * k, 0)}
        f32_ms = 2 * n * d * e / 67e12 * 1e3   # f32 FMA peak, 67 TFLOP/s
        print(f"phase 24 moe_route N={n} (dim {d}, {e} experts, top {k}): "
              f"offsets, rows, positions and the running count the twin's "
              f"sort of its choices {sort_exact}; choices the twin's on "
              f"cuBLAS's scores {chosen_exact} on the {100 * share:.2f}% of "
              f"rows whose top {k + 1} picks lie > 1e-5 apart, weights max "
              f"rel err {w_err:.2e} there; combine within one bf16 rounding "
              f"of its twin {within} | route {ms['route']:.4f} ms (in a "
              f"graph {graph['route']:.4f}), twin {ms['route twin']:.4f}, "
              f"chain {ms['route chain']:.4f} (in a graph "
              f"{graph['route chain']:.4f}), bound "
              f"{bounds['route']['bound_ms']:.4f} (bytes; f32 FMA "
              f"{f32_ms:.4f}) | combine {ms['combine']:.4f} ms (in a graph "
              f"{graph['combine']:.4f}), twin {ms['combine twin']:.4f}, "
              f"chain {ms['combine chain']:.4f} (in a graph "
              f"{graph['combine chain']:.4f}), bound "
              f"{bounds['combine']['bound_ms']:.4f} | {card}", flush=True)
        _check(sort_exact and chosen_exact and share > 0.9 and w_err < 1e-5
               and within and int(arrived) == 0,
               f"moe_route N={n}: sort {sort_exact}, choices {chosen_exact}"
               f" on {share}, weights {w_err}, combine {within}")
        for name in ("route", "combine"):
            out[name, n] = {
                "max_abs_err": _max_err(r.weights[clear],
                                        want.weights[clear])
                if name == "route" else _max_err(got, comb),
                "ms": ms[name], "plain_ms": ms[f"{name} twin"],
                "library_ms": ms[f"{name} chain"],
                "graph_ms": graph[name],
                "library_graph_ms": graph[f"{name} chain"], **bounds[name]}
    out["launches"] = _routed_launches(card)
    return out


def _entry(r: dict) -> dict:
    """A kernel's measured numbers for the ``kernels`` line; library_ms is
    null where no one PyTorch call computes the same function. ``ms`` and
    ``library_ms`` are back to back; K6 / K7 add their medians in turns."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {**{key: r.get(key) for key in keys},
            **{key: r[key] for key in ("ms_in_turns", "library_ms_in_turns")
               if key in r}}


def main() -> int:
    import torch
    from frankenstein_tpu_torch.ops.cuda import flash_attention as k67
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card(card)
    k1 = phase_k1(card)
    k2 = phase_k2(card)
    franky = _flagship()
    sl = phase_slice(card, franky)
    k3 = phase_k3(card)
    k2q = phase_k2_int8(card)
    bm = phase_beams(card, franky)
    del franky
    k4 = phase_k4(card)
    tr = phase_train(card)
    k5 = phase_k5(card)
    model = _franky_llama()
    fl = phase_franky_llama(card, model)
    del model
    fa = phase_flash(card)
    mae = phase_mae(card)
    k9 = phase_k9(card)
    phase_repair(card)
    k8 = phase_k8(card)
    k10 = phase_k10(card)
    served = phase_served(card)
    probes = phase_probes(card)
    rest = phase_rest(card)
    phase_whisper(card)
    phase_vq(card)
    phase_moe(card)
    routing = phase_moe_route(card)
    # last: a profiling child started while this process's profiler is
    # initialised drops records from this process's later profiles
    _decode_profile(card)
    k5_topk = k5[("FrankyLlama", 32, True, False)]
    k5_beam = k5[("FrankyLlama", 160, True, True)]
    kernels = [
        {"name": "slab_rope_attention_fwd", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/slab_rope_attention_fwd.cu",
         "replaces": "frankenstein_tpu/ops/pallas/block_attention.py:1454",
         "launches": sl["launches"]["K1"], **_entry(k1)},
        {"name": "fused_decode_blocks", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/fused_decode.cu",
         "replaces": "frankenstein_tpu/ops/pallas/fused_decode.py:614",
         "launches": sl["launches"]["K2"], **_entry(k2["w8a16"])},
        {"name": "fused_decode_blocks_int8_kv", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/fused_decode.cu",
         "replaces": "frankenstein_tpu/ops/pallas/fused_decode.py:99",
         "launches": bm["launches"]["K2-int8"],
         **_entry(k2q[("w8a16", 160)])},
        {"name": "beam_reorder", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/beam_reorder.cu",
         "replaces": "frankenstein_tpu/ops/pallas/beam_reorder.py:71",
         "launches": bm["launches"]["K3"], **_entry(k3["int8"])},
        {"name": "slab_rope_attention_bwd", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/slab_rope_attention_bwd.cu",
         "replaces": "frankenstein_tpu/ops/pallas/block_attention.py:658 "
                     "(_bwd_packed, calls :685, :721; and _bwd :396), from "
                     ":1595 with its rotations",
         "launches": tr["launches"]["K4"], **_entry(k4)},
        {"name": "fused_llama_decode_blocks", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/fused_llama_decode.cu",
         "replaces": "frankenstein_tpu/ops/pallas/fused_llama_decode.py:1003"
                     " (and :887, :812)",
         "launches": fl["top_launches"]["K5"], **_entry(k5_topk)},
        {"name": "fused_llama_decode_blocks_int8_kv", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/fused_llama_decode.cu",
         "replaces": "frankenstein_tpu/ops/pallas/fused_llama_decode.py:1003"
                     " (and :887, :812)",
         "launches": fl["launches"]["K5-int8"], **_entry(k5_beam)},
    ]
    for key, mode, fwd_at, bwd_at in (
            ("K6", "positions", "202 (_fwd with pos, call :260)",
             "396 (_bwd with pos, calls :436, :484)"),
            ("K7", "dense", "945 (_fwd_packed_call, call :976; and _fwd "
             ":260)", "658 (_bwd_packed, calls :685, :721; and _bwd :396)"),
            ("K7-slab", "slab", "945 (_fwd_packed_call, call :976; and "
             "_fwd :260)", "658 (_bwd_packed, calls :685, :721; and _bwd "
             ":396)")):
        fwd, bwd = fa[mode]
        src = "frankenstein_tpu_torch/csrc/flash_attention_dense.cu"
        # K7 slab's entries name its kernels' symbols (mode slab of the
        # dense file's passes)
        names = ((k67.SLAB_KERNELS[0], ", ".join(k67.SLAB_KERNELS[1:]))
                 if mode == "slab" else (f"flash_attention_fwd_{mode}",
                                         f"flash_attention_bwd_{mode}"))
        kernels += [
            {"name": names[0], "route": "cuda", "source": src,
             "replaces": f"frankenstein_tpu/ops/pallas/block_attention.py:"
                         f"{fwd_at}",
             "launches": mae["launches"][key], **_entry(fwd)},
            {"name": names[1], "route": "cuda", "source": src,
             "replaces": f"frankenstein_tpu/ops/pallas/block_attention.py:"
                         f"{bwd_at}",
             "launches": mae["launches"][f"{key}-bwd"], **_entry(bwd)}]
    for kind in ("layernorm", "rmsnorm"):
        # the RMSNorm kind's model path is SimpleMAE's (phase 20)
        kernels.append(
            {"name": f"fused_norm_swiglu_{kind}", "route": "cuda",
             "source": "frankenstein_tpu_torch/csrc/fused_mlp.cu",
             "replaces": "frankenstein_tpu/ops/pallas/fused_mlp.py:125 "
                         "(call :135)",
             "launches": (sl["launches"]["K9"] if kind == "layernorm"
                          else rest["simple_mae"]["k9_rmsnorm"]),
             **_entry(k9[(kind, "encoder" if kind == "layernorm"
                          else "SimpleMAE encoder")])})
    kernels += [
        {"name": "lm_head_norm, lm_head_topk_wgmma", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/lm_head_topk.cu",
         "replaces": "frankenstein_tpu/ops/pallas/lm_head_topk.py:86",
         "launches": served["launches"][(128, True)]["K8"],
         **_entry(k8[128])},
        {"name": "slab_rope_attention_fwd_int8", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/slab_rope_attention_int8.cu",
         "replaces": "frankenstein_tpu/ops/pallas/block_attention.py:1334 "
                     "(qk_int8)",
         "launches": served["launches"][(128, True)]["K10"],
         **_entry(k10)},
        {"name": "slab_attention_probe", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/slab_rope_attention_fwd.cu",
         "replaces": "tools/attn_probe.py:137 (_variant_call, call :167)",
         "launches": probes["launches"][0], **_entry(probes["kernel"])},
        {"name": "slab_attention_probe_int8", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/slab_rope_attention_int8.cu",
         "replaces": "tools/int8_attr_probe.py:165 (_call, call :197)",
         "launches": probes["launches"][1], **_entry(probes["int8_full"])}]
    # the routed experts' kernels (port-only, no Pallas site), at the
    # decode step's 160 rows; the prefill's 5280 beside them
    routed = routing["launches"]
    for i, name in enumerate(("route", "combine")):
        kernels.append(
            {"name": f"moe_{name}", "route": "cuda",
             "source": "frankenstein_tpu_torch/csrc/moe_route.cu",
             "replaces": "none (port-only: models/moe.py:RoutedExperts' "
                         "routing chain)",
             "launches": routed["step"][i],
             "launches_of": f"a replayed decode step of 160 rows, LFM2 at "
                            f"full width cut to {routed['layers']} layers "
                            f"({routed['routed']} routed)",
             "prefill_launches": routed["prefill"][i],
             **_entry(routing[name, 160]),
             "graph_ms": routing[name, 160]["graph_ms"],
             "library_graph_ms": routing[name, 160]["library_graph_ms"],
             "at_5280": _entry(routing[name, 5280])})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
