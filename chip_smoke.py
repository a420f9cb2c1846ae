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
   (random weights from a seed, bf16, w8a16 decode), with the launch counts
   of both kernels, output checks, an f32 CPU cross-check of the chain, and
   encode / decode times at batch 128.

Then one JSON line with the kernels' results, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: non-zero exit and no
``ok`` line. Without a CUDA device it exits non-zero before printing a
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
K1_TOL = 3e-2     # bf16 kernel vs f32 twin: rotated q/k and p round to bf16
K2_TOL = 2e-2     # relative to max |twin|: same roundings, other f32 order
SLICE_TOL = 1e-1  # bf16 card chain vs f32 CPU twins, relative to max |ref|


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
    qb, kb, vb = (torch.randn(128, t, h * d, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
    ms_b128 = _time_ms(lambda: k1.slab_rope_attention(qb, kb, vb, cos, sin,
                                                      **kw), iters=3)
    print(f"phase 2 K1 slab_rope_attention B={b} T={t} E={h * d} H={h} "
          f"P={p} bf16: out max_abs_err {err_out:.3e} (rel {rel_out:.3e}), "
          f"lse max_abs_err {err_lse:.3e} (rel {rel_lse:.3e}), tol {K1_TOL} "
          f"| kernel {ms:.3f} ms, plain {plain_ms:.3f} ms | kernel at B=128 "
          f"{ms_b128:.3f} ms | {card}", flush=True)
    _check(torch.isfinite(out).all() and torch.isfinite(lse).all(),
           "K1 output not finite")
    _check(err_out <= K1_TOL and err_lse <= K1_TOL,
           f"K1 disagrees with its twin: out {err_out}, lse {err_lse}")
    return {"max_abs_err": max(err_out, err_lse), "ms": ms,
            "plain_ms": plain_ms, "ms_b128": ms_b128}


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
              f"{plain_ms:.4f} ms | B=128 kernel {ms_b128:.4f} ms, plain "
              f"{plain_b128:.4f} ms | {card}", flush=True)
        _check(torch.isfinite(xo).all(), f"K2 {mode} output not finite")
        _check(err_x <= K2_TOL * scale and err_row <= K2_TOL * row_scale,
               f"K2 {mode} disagrees with its twin: x {err_x}, row {err_row}")
        _check(untouched, f"K2 {mode} wrote outside row {length}")
        results[mode] = {"max_abs_err": max(err_x, err_row), "ms": ms,
                         "plain_ms": plain_ms, "ms_b128": ms_b128,
                         "plain_ms_b128": plain_b128}
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


def phase_slice(card: str) -> dict:
    import torch
    from frankenstein_tpu_torch.config import FrankyConfig, GPT2_EOT
    from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
    from frankenstein_tpu_torch.decode import pipeline, sampling
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.models.weights import init_franky_
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1

    dev = torch.device("cuda")
    cfg = FrankyConfig()
    enc = cfg.brain.encoder
    model = init_franky_(Franky(cfg, device=dev), seed=SEED)
    model = pipeline.cast_params_for_inference(model)
    predict = pipeline.make_franky_predictor(model, ByteTokenizer(),
                                             int8_weights=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = torch.randn(8, enc.window_size, enc.n_electrodes, generator=gen,
                     device=dev)

    k1.launches, k2.launches = 0, 0
    out = predict(xs)
    torch.cuda.synchronize()
    launches = {"K1": k1.launches, "K2": k2.launches}

    _check(len(out) == 8 and all(isinstance(s, str) for s in out),
           f"predictor returned {out!r}")
    _check(launches["K1"] == enc.n_layers, f"K1 launches {launches}")
    _check(launches["K2"] == cfg.max_tokens, f"K2 launches {launches}")
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
    sl = phase_slice(card)
    kernels = [
        {"name": "slab_rope_attention_fwd", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/slab_rope_attention.cu",
         "replaces": "frankenstein_tpu/ops/pallas/block_attention.py:1454",
         "launches": sl["launches"]["K1"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "fused_decode_blocks", "route": "cuda",
         "source": "frankenstein_tpu_torch/csrc/fused_decode.cu",
         "replaces": "frankenstein_tpu/ops/pallas/fused_decode.py:614",
         "launches": sl["launches"]["K2"],
         "max_abs_err": k2["w8a16"]["max_abs_err"], "ms": k2["w8a16"]["ms"],
         "plain_ms": k2["w8a16"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
