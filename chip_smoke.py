"""Chip smoke test of the PyTorch + CUDA port (``frankenstein_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``frankenstein_tpu_torch/csrc`` with
nvcc (sm_90a) and then, one line per phase:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the kernel build time;
2. kernel K1 (slab-causal RoPE attention) against its plain PyTorch twin at
   the flagship encoder shape, with both times;
3. kernel K2 (all-layer GPT-2 decode step) against its twin at GPT-2 124M
   width, bf16 and w8a16 weights, with both times;
4. the flagship Franky served end to end through ``make_franky_predictor``
   (random weights from a seed, bf16, w8a16 decode, top-k 10), with the
   launch counts of the kernels, output checks, an f32 CPU cross-check of
   the chain, and encode / decode times at batch 128;
5. kernel K3 (beam-search cache reorder) against its twin at the flagship
   beam shape, bf16 and int8, and at FrankyLlama's int8 beam cache
   [8, 160, 64, 512], bitwise, with both times;
6. kernel K2's int8-KV mode against its twin at GPT-2 124M width, B*W=160
   and B=8, bf16 and w8a16 weights, with both times;
7. the beam path: the same flagship served through ``make_franky_predictor
   (beam_width=5, int8_kv=True, int8_weights=True)`` at batch 32, with the
   launch counts of K1, K2 (int8-KV mode) and K3, beam width 1 against
   greedy, the int8-KV logits against the bf16 cache's,
   ``evaluate_franky_wer`` over a synthetic set, the submission writer,
   and encode / beam decode / request times;
8. kernel K4 (the backward of K1) against its twin at the flagship encoder
   shape: dq, dk, dv, the probability rows it recomputes (each sums to 1
   against K1's lse), two launches bitwise equal, both times, and the
   kernel at B=32;
9. training: the flagship Franky (f32 parameters, bf16 compute) trained
   for 30 steps at B=32 on synthetic trials through the train CLI
   (``python -m frankenstein_tpu_torch.train --config configs/franky.yaml``,
   called in-process), with an eval and a checkpoint: finite, falling
   losses, the launch counts of K1 and K4, one step's gradients against an
   f32 CPU twin at B=1, the checkpoint restored bitwise, the run served
   by ``python -m frankenstein_tpu_torch.submit --run-dir`` over 8
   synthetic windows; then the step time, samples/s and peak memory at
   B=32, and one step at the YAML's batch 256 with grad_accum 8;
10. kernel K5 (all-layer LLaMA decode step, GQA over the unexpanded cache)
    against its twin in all four modes: at FrankyLlama width (L=8, E=1024,
    16 heads on 8 KV heads, F=2816, S=64) with B*W=160 and an int8 cache
    (w8a16 and bf16 weights) and B=32 with a bf16 cache (bf16 and w8a16),
    and at a 1B-class shape (E=2048, head_dim 128, F=5632, L=16, B=8, S=48,
    bf16 and w8a16): errors, int8 codes (equal to the twin's off ties in
    layer 0, at most one apart deeper), the exact rounding rule, a 3-step
    chain across row 8, two launches bitwise equal, both times;
11. FrankyLlama (``configs/franky_llama.yaml``'s model: the flagship encoder,
    a 2-layer Perceiver into a ~110M LLaMA) served end to end through
    ``make_franky_predictor(beam_width=5, int8_kv=True, int8_weights=True,
    rescorer=(fl,))`` at batch 32 (random weights from a seed, bf16): the
    launch counts of K1, K5 (int8-KV mode) and K3, whether the rescorer
    moved a row off its first beam, beam width 1 against greedy, the int8-KV
    logits against a bf16 cache's, an f32 CPU cross-check, the top-k path,
    and the median and range over 5 runs of encode / beam decode / rescore
    (timed stage by stage within one chain) and of the whole request.

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
import subprocess
import sys
import time

SEED = 0
K1_TOL = 3e-2     # bf16 kernel vs f32 twin: rotated q/k and p round to bf16
K2_TOL = 2e-2     # relative to max |twin|: same roundings, other f32 order
SLICE_TOL = 1e-1  # bf16 card chain vs f32 CPU twins, relative to max |ref|
CODE_WINDOW = 1e-3  # how near a .5 tie a value counts as a tie
INT8_KV_TOL = 5e-2  # int8 vs bf16 cache logits, relative to the logit range
K4_TOL = 2e-2     # relative to max |twin|: ds, p, dq, dk round to bf16
ROWSUM_TOL = 1e-2   # |sum of a recomputed probability row - 1|
GRAD_TOL = 5e-2   # bf16 card step vs f32 CPU twin, relative (norms)
TRAIN_STEPS = 30
TIMING_REPEATS = 5  # timed runs of each phase-11 stage and request
K5_TOL = 2e-2     # relative to max |twin|: the same bf16 roundings, other
                  # f32 summation order
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core peak, same source


def _bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the bf16 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
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


def phase_k1(card: str) -> dict:
    import torch
    from frankenstein_tpu_torch.ops import rope
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    b, t, h, d, p = 2, 6144, 8, 32, 256
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(b, t, h * d, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    cos, sin = rope.folded_tables(rope.build_rope_cache(d, t, device=dev),
                                  1)
    kw = dict(n_heads=h, tok_per_time=p)
    out, lse = k1.slab_rope_attention(q, k, v, cos, sin, **kw)
    ref_out, ref_lse = k1.slab_rope_attention_ref(q.float(), k.float(),
                                                  v.float(), cos, sin, **kw)
    torch.cuda.synchronize()
    err_out, err_lse = _max_err(out, ref_out), _max_err(lse, ref_lse)
    rel_out = err_out / float(ref_out.abs().max())
    rel_lse = err_lse / float(ref_lse.abs().max())
    ms = _time_ms(lambda: k1.slab_rope_attention(q, k, v, cos, sin, **kw))
    plain_ms = _time_ms(lambda: k1.slab_rope_attention_ref(q, k, v, cos, sin,
                                                           **kw), iters=3)
    library_ms = _time_ms(_sdpa_slab(q, k, v, cos, sin, h, p), iters=3)
    bound = _bound(_nbytes(q, k, v, cos, sin, out, lse),
                   4 * d * h * b * _slab_pairs(t, p))
    qb, kb, vb = (torch.randn(128, t, h * d, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
    ms_b128 = _time_ms(lambda: k1.slab_rope_attention(qb, kb, vb, cos, sin,
                                                      **kw), iters=3)
    print(f"phase 2 K1 slab_rope_attention B={b} T={t} E={h * d} H={h} "
          f"P={p} bf16: out max_abs_err {err_out:.3e} (rel {rel_out:.3e}), "
          f"lse max_abs_err {err_lse:.3e} (rel {rel_lse:.3e}), tol {K1_TOL} "
          f"| kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), SDPA with the "
          f"slab mask {library_ms:.3f} ms | kernel at B=128 "
          f"{ms_b128:.3f} ms | {card}", flush=True)
    _check(torch.isfinite(out).all() and torch.isfinite(lse).all(),
           "K1 output not finite")
    _check(err_out <= K1_TOL and err_lse <= K1_TOL,
           f"K1 disagrees with its twin: out {err_out}, lse {err_lse}")
    return {"max_abs_err": max(err_out, err_lse), "ms": ms,
            "plain_ms": plain_ms, "ms_b128": ms_b128,
            "library_ms": library_ms, **bound}


def _sdpa_heads(q, k, v, cos, sin, h):
    """[B, T, E] -> [B, H, T, D], q and k rotated (the kernel's RoPE)."""
    from frankenstein_tpu_torch.ops import rope
    b, t, e = q.shape
    heads = lambda x: x.reshape(b, t, h, e // h).transpose(1, 2)
    return (rope.apply_rope_folded(heads(q), cos, sin),
            rope.apply_rope_folded(heads(k), cos, sin), heads(v))


def _slab_mask(t: int, p: int, dev):
    """[T, T] bool: query i may see key j when slab(j) <= slab(i)."""
    import torch
    i = torch.arange(t, device=dev)
    return (i[None, :] // p) <= (i[:, None] // p)


def _sdpa_slab(q, k, v, cos, sin, h, p):
    """One ``scaled_dot_product_attention`` call on pre-rotated q, k with
    the boolean slab mask: K1's library yardstick (never used by the
    port)."""
    import torch.nn.functional as F
    qh, kh, vh = _sdpa_heads(q, k, v, cos, sin, h)
    mask = _slab_mask(q.shape[1], p, q.device)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                  attn_mask=mask)


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
    return _bound(n_bytes, ops)


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
        kc_r, vc_r = kc.clone(), vc.clone()
        xo, _, _ = k2.fused_decode_blocks(x, st, kc_k, vc_k, length,
                                          n_head=n_head)
        xr, _, _ = k2.fused_decode_blocks_ref(x, st, kc_r, vc_r, length,
                                              n_head=n_head)
        torch.cuda.synchronize()
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
        xb, stb, kcb, vcb = _k2_inputs(128, gen, w8)
        ms_b128 = _time_ms(lambda: k2.fused_decode_blocks(
            xb, stb, kcb, vcb, length, n_head=n_head))
        plain_b128 = _time_ms(lambda: k2.fused_decode_blocks_ref(
            xb, stb, kcb, vcb, length, n_head=n_head))
        print(f"phase 3 K2 fused_decode_blocks {mode} L=12 E=768 H=12 S=64 "
              f"B={b} length={length}: x_out max_abs_err {err_x:.3e} "
              f"(max|x| {scale:.3f}), new-row max_abs_err {err_row:.3e} "
              f"(max|row| {row_scale:.3f}), other rows untouched "
              f"{untouched}, tol {K2_TOL} x max | kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}) | B=128 kernel {ms_b128:.4f} ms, plain "
              f"{plain_b128:.4f} ms | {card}", flush=True)
        _check(torch.isfinite(xo).all(), f"K2 {mode} output not finite")
        _check(err_x <= K2_TOL * scale and err_row <= K2_TOL * row_scale,
               f"K2 {mode} disagrees with its twin: x {err_x}, row {err_row}")
        _check(untouched, f"K2 {mode} wrote outside row {length}")
        results[mode] = {"max_abs_err": max(err_x, err_row), "ms": ms,
                         "plain_ms": plain_ms, "ms_b128": ms_b128,
                         "plain_ms_b128": plain_b128, **bound}
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


def _flagship():
    """The flagship Franky on the card: random weights from SEED, bf16."""
    import torch
    from frankenstein_tpu_torch.config import FrankyConfig
    from frankenstein_tpu_torch.decode import pipeline
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.models.weights import init_franky_
    model = init_franky_(Franky(FrankyConfig(), device=torch.device("cuda")),
                         seed=SEED)
    return pipeline.cast_params_for_inference(model)


def _reset_launches() -> None:
    from frankenstein_tpu_torch.ops.cuda import beam_reorder as k3
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    from frankenstein_tpu_torch.ops.cuda import fused_llama_decode as k5
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    k1.launches = k1.launches_bwd = 0
    k2.launches = k2.launches_int8_kv = k3.launches = 0
    k5.launches = k5.launches_int8_kv = 0


def _read_launches() -> dict:
    from frankenstein_tpu_torch.ops.cuda import beam_reorder as k3
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    from frankenstein_tpu_torch.ops.cuda import fused_llama_decode as k5
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    return {"K1": k1.launches, "K2": k2.launches,
            "K2-int8": k2.launches_int8_kv, "K3": k3.launches,
            "K4": k1.launches_bwd, "K5": k5.launches,
            "K5-int8": k5.launches_int8_kv}


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
                        "K5-int8": 0},
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
    encode_ms = _time_ms(lambda: model.encode(xb), iters=3, warmup=1)
    pb = model.encode(xb)
    idx_b = torch.full((128, 1), GPT2_EOT, dtype=torch.long, device=dev)
    qw = sampling.quantize_serving_weights(model)
    decode_ms = _time_ms(lambda: sampling.generate(
        model, idx_b, pb, gen, max_new_tokens=25, top_k=10, qweights=qw),
        iters=3, warmup=1)
    request_ms = _time_ms(lambda: predict(xs), iters=3, warmup=1)
    print(f"phase 4 slice: Franky flagship (768x256 window, 6144 tokens, "
          f"GPT-2 124M, bf16, w8a16 decode, top-k 10, 25 tokens): "
          f"{len(out)} strings, launches {launches} (K1 = {enc.n_layers} per "
          f"encode, K2 = {cfg.max_tokens} per request), prefill logits "
          f"finite, token ids in [0, {cfg.gpt.vocab_size}), card vs f32 CPU "
          f"twins rel err prefix {errs['prefix']:.3e} logits "
          f"{errs['logits']:.3e} (tol {SLICE_TOL}) | B=128 encode "
          f"{encode_ms:.1f} ms, decode {decode_ms:.1f} ms | B=8 request "
          f"{request_ms:.1f} ms | {card}", flush=True)
    return {"launches": launches, "encode_ms_b128": encode_ms,
            "decode_ms_b128": decode_ms, "request_ms_b8": request_ms}


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
            kc_r, vc_r = kc.clone(), vc.clone()
            xo, _, _ = k2.fused_decode_blocks(x, st, kc_k, vc_k, length, ks,
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
            ms = _time_ms(lambda: k2.fused_decode_blocks(
                x, st, kc_k, vc_k, length, ks, vs, n_head=n_head))
            plain_ms = _time_ms(lambda: k2.fused_decode_blocks_ref(
                x, st, kc_r, vc_r, length, ks, vs, n_head=n_head))
            print(f"phase 6 K2 fused_decode_blocks int8 KV, {mode} weights, "
                  f"L=12 E=768 H=12 S=64 B={b} length={length}: x_out "
                  f"max_abs_err {err_x:.3e} (max|x| {scale:.3f}), tol "
                  f"{K2_TOL} x max | new-row codes vs twin k {codes[0]} v "
                  f"{codes[1]} (tie window {CODE_WINDOW}) | exact-row "
                  f"codes wrong {exact} | other rows untouched {untouched} "
                  f"| kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}) | "
                  f"{card}", flush=True)
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
                                  "plain_ms": plain_ms, **bound}
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
                        "K3": steps, "K4": 0, "K5": 0, "K5-int8": 0},
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
    print(f"phase 7 beams: Franky flagship, beam width {w}, int8 KV, w8a16, "
          f"{steps} tokens, B={b}: {len(out)} strings, launches {launches} "
          f"(K1 = {enc.n_layers} per encode, K2 and K3 = {steps} per "
          f"request), beam width 1 == greedy, int8-KV logit drift "
          f"{drift:.3e} of the range (tol {INT8_KV_TOL}), synthetic WER "
          f"{wer:.4f} over {len(preds)} trials, submission {len(lines)} "
          f"lines | B={b} encode {encode_ms:.1f} ms, beam decode "
          f"{decode_ms:.1f} ms, request {request_ms:.1f} ms | {card}",
          flush=True)
    return {"launches": launches, "encode_ms": encode_ms,
            "decode_ms": decode_ms, "request_ms": request_ms}


def _k4_inputs(b: int, gen, dout=None):
    """Flagship encoder attention: bf16 q, k, v (and dout), K1's out, lse."""
    import torch
    from frankenstein_tpu_torch.ops import rope
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    t, h, d, p = 6144, 8, 32, 256
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


def phase_k4(card: str) -> dict:
    import torch
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    b, t, h, d = 2, 6144, 8, 32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    args, kw = _k4_inputs(b, gen)
    got = k1.slab_rope_attention_bwd(*args, **kw)
    again = k1.slab_rope_attention_bwd(*args, **kw)
    want = k1.slab_rope_attention_bwd_ref(*(x.float() for x in args), **kw)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(g, a) for g, a in zip(got, again))
    errs = [_max_err(g, w) for g, w in zip(got, want)]
    rels = [e / float(w.abs().max()) for e, w in zip(errs, want)]

    # dout one-hot on (query i_c, lane c) of every head: column c of dv is
    # then row i_c of the probabilities K4 recomputes from K1's lse
    rows = torch.arange(d, device="cuda") * 191 % t
    onehot = torch.zeros(b, t, h * d, dtype=torch.bfloat16, device="cuda")
    for head in range(h):
        onehot[:, rows, head * d + torch.arange(d, device="cuda")] = 1.0
    pargs, _ = _k4_inputs(b, gen, dout=onehot)
    _, _, dv = k1.slab_rope_attention_bwd(*pargs, **kw)
    rowsum = float((dv.float().reshape(b, t, h, d).sum(dim=1) - 1.0)
                   .abs().max())

    ms = _time_ms(lambda: k1.slab_rope_attention_bwd(*args, **kw))
    plain_ms = _time_ms(lambda: k1.slab_rope_attention_bwd_ref(*args, **kw),
                        iters=3)
    # five products of D per visible (query, key) pair against K1's two
    bound = _bound(_nbytes(*args, *got), 10 * d * h * b * _slab_pairs(t, 256))
    library_ms = _time_ms(_sdpa_slab_bwd(args, h, 256), iters=3)
    bargs, _ = _k4_inputs(32, gen)
    ms_b32 = _time_ms(lambda: k1.slab_rope_attention_bwd(*bargs, **kw),
                      iters=5)
    print(f"phase 8 K4 slab_rope_attention_bwd B={b} T={t} E={h * d} H={h} "
          f"P=256 bf16: dq/dk/dv max_abs_err {errs[0]:.3e}/{errs[1]:.3e}/"
          f"{errs[2]:.3e} (rel {rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e}, "
          f"tol {K4_TOL} x max|twin|), probability rows sum to 1 within "
          f"{rowsum:.3e} (tol {ROWSUM_TOL}), two launches bitwise equal "
          f"{bitwise} | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), SDPA backward "
          f"{library_ms:.3f} ms | kernel at B=32 {ms_b32:.3f} ms | {card}",
          flush=True)
    _check(all(bool(torch.isfinite(g).all()) for g in got),
           "K4 output not finite")
    _check(max(rels) <= K4_TOL, f"K4 disagrees with its twin: {rels}")
    _check(rowsum <= ROWSUM_TOL, f"K4 probability rows off by {rowsum}")
    _check(bitwise, "K4 is not deterministic")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "ms_b32": ms_b32, "library_ms": library_ms, **bound}


def _sdpa_slab_bwd(args, h: int, p: int):
    """The backward of ``_sdpa_slab``'s call for the same dout: K4's library
    yardstick (never used by the port)."""
    import torch
    import torch.nn.functional as F
    q, k, v, cos, sin, _, _, dout = args
    qh, kh, vh = (a.detach().requires_grad_()
                  for a in _sdpa_heads(q, k, v, cos, sin, h))
    mask = _slab_mask(q.shape[1], p, q.device)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    dh = dout.reshape(out.shape[0], out.shape[2], h, -1).transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qh, kh, vh), dh,
                                       retain_graph=True)


def _grad_check(state, tcfg, ds) -> dict:
    """One step's gradients on the card (bf16 compute) against the same
    weights as f32 on the CPU (the kernels' twins), at B=1: relative error
    of the global norm and of each encoder attention weight."""
    import torch
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.train import trainer
    x, y, _ = ds[0]
    batch = (torch.from_numpy(x[None]), torch.from_numpy(y[None]))
    state.optimizer.zero_grad(set_to_none=True)
    trainer.loss_and_grads(state, tuple(a.cuda() for a in batch),
                           tcfg.replace(grad_accum=1, p_augs=0.0))
    ref = Franky(state.model.cfg)
    ref.load_state_dict({k: v.cpu() for k, v in
                         state.model.state_dict().items()})
    ref(*batch)[0].backward()
    card = {n: p.grad.cpu() for n, p in state.model.named_parameters()}
    cpu = {n: p.grad for n, p in ref.named_parameters()}
    norm = lambda g: float(torch.sqrt(sum((v.double() ** 2).sum()
                                          for v in g.values())))
    errs = {"global_norm": abs(norm(card) - norm(cpu)) / norm(cpu)}
    for n in cpu:
        if n.startswith("brain_model.encoder.") and ".attn." in n:
            errs[n] = float((card[n] - cpu[n]).norm() / cpu[n].norm())
    state.optimizer.zero_grad(set_to_none=True)
    return errs


def _time_steps(state, tcfg, ds, batch_size: int, steps: int):
    """(ms per step, peak GiB) of ``steps`` train steps after one warm-up."""
    import torch
    from frankenstein_tpu_torch.data.datasets import batch_iterator
    from frankenstein_tpu_torch.train import trainer
    from frankenstein_tpu_torch.train.schedule import make_lr_schedule
    it = batch_iterator(ds, batch_size, shuffle=True, seed=SEED)
    batches = [tuple(torch.from_numpy(a).cuda() for a in next(it))[:2]
               for _ in range(steps + 1)]
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


def phase_train(card: str) -> dict:
    import tempfile
    from pathlib import Path

    import torch
    from frankenstein_tpu_torch import submit
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.train import __main__ as train_cli
    from frankenstein_tpu_torch.train import checkpoints as ckpt_lib
    from frankenstein_tpu_torch.train import trainer

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
        records = [json.loads(line) for line in
                   (run_dir / "metrics.jsonl").read_text().splitlines()]
        losses = [r["train/loss"] for r in records if "train/loss" in r]
        rate = [r["samples_per_sec"] for r in records
                if "samples_per_sec" in r]
        val = [r["val/loss"] for r in records if "val/loss" in r]
        cfg = state.model.cfg
        n_layers = cfg.brain.encoder.n_layers
        _check(state.step == TRAIN_STEPS, f"stopped at step {state.step}")
        _check(len(losses) >= 2 and all(map(math.isfinite, losses + val)),
               f"losses {losses}, val {val}")
        _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        # one eval batch: 32 validation trials at batch 32
        _check(launches["K4"] == n_layers * TRAIN_STEPS
               and launches["K1"] == n_layers * (TRAIN_STEPS + 1)
               and launches["K2"] == launches["K3"] == launches["K5"] == 0,
               f"training launches {launches}")

        best = ckpt_lib.best_checkpoint(run_dir)
        fresh = Franky(cfg, device=torch.device("cuda"),
                       dtype=torch.bfloat16)
        tcfg = _train_config(run_dir)
        restored = ckpt_lib.restore_checkpoint(best, trainer.TrainState(
            fresh, trainer.make_optimizer(tcfg, fresh)[0]))
        same = (restored.step == state.step and all(
            torch.equal(a, b) for a, b in zip(
                state.model.state_dict().values(),
                fresh.state_dict().values())))
        opt_a = state.optimizer.state_dict()["state"]
        opt_b = restored.optimizer.state_dict()["state"]
        same = same and all(torch.equal(opt_a[i][key], opt_b[i][key])
                            for i in opt_a for key in opt_a[i])
        _check(same, f"checkpoint {best.name} does not restore bitwise")
        del fresh, restored

        sub = submit.main(["--run-dir", str(run_dir), "--data", "synthetic",
                           "--synthetic-trials", "8", "--out",
                           str(Path(tmp) / "sub.txt")])
        lines = sub.read_text().splitlines()
        _check(len(lines) == 8, f"submission has {len(lines)} lines")

        ds = train_cli.build_datasets("synthetic", 768, 256, 256)[0]
        grad_errs = _grad_check(state, tcfg, ds)
        step_ms, peak = _time_steps(state, tcfg, ds, 32, 5)
        big = tcfg.replace(batch_size=256, grad_accum=8)
        big_ms, big_peak = _time_steps(state, big, ds, 256, 1)
    worst = max(grad_errs, key=grad_errs.get)
    print(f"phase 9 training: Franky flagship (768x256 window, 6144 tokens, "
          f"GPT-2 124M, f32 params, bf16 compute), {TRAIN_STEPS} steps at "
          f"B=32 through the train CLI in {run_s:.1f} s: train loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (logged {len(losses)}), val "
          f"{val[-1]:.4f}, samples/s in the log {rate[-1]:.1f}, launches "
          f"{launches} (K4 = {n_layers} per step, K1 = {n_layers} per "
          f"forward), checkpoint {best.name} restored bitwise, submit "
          f"--run-dir wrote {len(lines)} lines | B=1 card vs f32 CPU twin "
          f"gradients: global norm rel err {grad_errs['global_norm']:.3e}, "
          f"worst encoder attention weight {worst} {grad_errs[worst]:.3e} "
          f"(tol {GRAD_TOL}) | B=32 step {step_ms:.1f} ms, "
          f"{32e3 / step_ms:.1f} samples/s, peak {peak:.2f} GiB | B=256 "
          f"grad_accum 8 step {big_ms:.1f} ms, peak {big_peak:.2f} GiB | "
          f"{card}", flush=True)
    _check(max(grad_errs.values()) <= GRAD_TOL,
           f"card vs CPU gradients: {grad_errs}")
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak,
            "big_ms": big_ms, "big_peak_gib": big_peak, "grad": grad_errs}


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
        ms = _time_ms(lambda: run(k5.fused_llama_decode_blocks, kc_a, vc_a,
                                  length))
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
              f"{exact} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}) | {card}",
              flush=True)
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
                                         "plain_ms": plain_ms, **bound}
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
                        "K5-int8": steps},
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
           and top_launches["K5-int8"] == 0 and top_launches["K3"] == 0,
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
          f"strings, launches {launches} (K1 = {enc.n_layers} per encode, "
          f"K5 int8-KV and K3 = {steps} per request), rescorer moved "
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


def _entry(r: dict) -> dict:
    """A kernel's measured numbers for the ``kernels`` line; library_ms is
    null where no one PyTorch call computes the same function."""
    return {key: r.get(key) for key in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")}


def main() -> int:
    import torch
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
    model = _flagship()
    sl = phase_slice(card, model)
    k3 = phase_k3(card)
    k2q = phase_k2_int8(card)
    bm = phase_beams(card, model)
    del model
    k4 = phase_k4(card)
    tr = phase_train(card)
    k5 = phase_k5(card)
    model = _franky_llama()
    fl = phase_franky_llama(card, model)
    del model
    k5_topk = k5[("FrankyLlama", 32, True, False)]
    k5_beam = k5[("FrankyLlama", 160, True, True)]
    kernels = [
        {"name": "slab_rope_attention_fwd", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/slab_rope_attention.cu",
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
         "replaces": "frankenstein_tpu/ops/pallas/block_attention.py:658",
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
