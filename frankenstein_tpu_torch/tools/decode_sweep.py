"""Profile and tune the all-layer decode steps K2 and K5 on the card.

``profile``: a few calls of ``fused_decode_blocks`` (GPT-2 124M width,
L=12, length 33) and ``fused_llama_decode_blocks`` (FrankyLlama width,
L=8, length 46) at the shapes the decode paths run, with random weights
from a seed. One JSON line a shape: the per-token ms (CUDA events, calls
back to back), the device operations a call and each kernel's summed
device ms a call (torch.profiler), and the gap between the two (launch
and drain time the device spends idle). It runs on any tree of the port,
so it also prices an older kernel (run it from that tree's root).

``sweep``: the persistent kernels' launch knobs (``fused_decode.TUNING``,
read on every call) in turns, one knob at a time from the production
setting: CTAs an SM, ring stages, depth splits (the target of work items
a product) and the N chunk (batch rows a product takes at once). One JSON
line a shape with each setting's median ms a call and its range over
``--repeats`` turns, and its output's largest difference from the
production setting's.

Run on a machine with the CUDA toolkit and a Hopper card::

    python -m frankenstein_tpu_torch.tools.decode_sweep profile
    python -m frankenstein_tpu_torch.tools.decode_sweep sweep
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import torch

SEED = 0
# (kernel, batch, w8a16 weights, int8 cache) of the decode paths
SHAPES = [("K2", 8, True, False), ("K2", 160, True, True),
          ("K2", 128, True, False), ("K5", 160, True, True),
          ("K5", 32, True, False)]


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _k2_case(b: int, w8: bool, int8: bool, gen):
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    n_layer, e, s, length, n_head = 12, 768, 64, 33, 12
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    st = {key: 0.02 * rnd(n_layer, n) for key, n in (
        ("ln1_w", e), ("ln1_b", e), ("qkv_b", 3 * e), ("proj_b", e),
        ("ln2_w", e), ("ln2_b", e), ("fc_b", 4 * e), ("fc2_b", e))}
    st["ln1_w"] += 1.0
    st["ln2_w"] += 1.0
    for key, (i, o) in (("qkv_w", (e, 3 * e)), ("proj_w", (e, e)),
                        ("fc_w", (e, 4 * e)), ("fc2_w", (4 * e, e))):
        st[key] = (0.02 * rnd(n_layer, i, o)).to(torch.bfloat16)
    if w8:
        st = k2.quantize_weights(st)
    kf, vf = rnd(n_layer, b, s, e), rnd(n_layer, b, s, e)
    if int8:
        (kc, ks), (vc, vs) = (k2.quantize_cache_side(c) for c in (kf, vf))
    else:
        kc, vc, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), \
            None, None
    x = rnd(b, e).to(torch.bfloat16)
    return lambda: k2.fused_decode_blocks(x, st, kc, vc, length, ks, vs,
                                          n_head=n_head)


def _k5_case(b: int, w8: bool, int8: bool, gen):
    from frankenstein_tpu_torch.ops import rope
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    from frankenstein_tpu_torch.ops.cuda import fused_llama_decode as k5
    n_layer, s, e, h, kv, f, length = 8, 64, 1024, 16, 8, 2816, 46
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    e_kv = kv * (e // h)
    st = {key: 1.0 + 0.1 * rnd(n_layer, e) for key in ("norm1_w",
                                                        "norm2_w")}
    for key, shape in (("wq", (e, e)), ("wk", (e, e_kv)), ("wv", (e, e_kv)),
                       ("wo", (e, e)), ("wg", (e, f)), ("wu", (e, f)),
                       ("wd", (f, e))):
        st[key] = (0.02 * rnd(n_layer, *shape)).to(torch.bfloat16)
    if w8:
        st = k5.quantize_weights(st)
    kf, vf = rnd(n_layer, b, s, e_kv), rnd(n_layer, b, s, e_kv)
    if int8:
        (kc, ks), (vc, vs) = (k2.quantize_cache_side(c) for c in (kf, vf))
    else:
        kc, vc, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), \
            None, None
    cos, sin = (a[length:length + 1] for a in rope.folded_tables(
        rope.build_rope_cache(e // h, s, device="cuda"), h))
    x = rnd(b, e).to(torch.bfloat16)
    return lambda: k5.fused_llama_decode_blocks(
        x, st, kc, vc, length, cos, sin, ks, vs, n_heads=h, n_kv_heads=kv,
        eps=1e-5)


def case(kernel: str, b: int, w8: bool, int8: bool):
    """One decode call of ``kernel`` ("K2" or "K5") at batch ``b``, its
    inputs made once from SEED."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return (_k2_case if kernel == "K2" else _k5_case)(b, w8, int8, gen)


def per_call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms a call over ``iters`` calls back to back (CUDA events)."""
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


def _kernel_name(key: str) -> str:
    """A profiler key without return type, namespaces and arguments, its
    template arguments kept: ``void (anonymous namespace)::f<int>(...)``
    -> ``f<int>``."""
    key = re.sub(r"\(anonymous namespace\)::|fk::", "", key)
    key = re.sub(r"^void ", "", key)
    depth, out = 0, []
    for ch in key:
        if ch == "(" and depth == 0:
            break
        depth += (ch == "<") - (ch == ">")
        out.append(ch)
    return "".join(out)[:80]


def kernel_split(fn, calls: int = 5) -> tuple:
    """(device operations a call, {kernel name: device ms a call}) over
    ``calls`` calls of fn (torch.profiler tracing host and device, after
    one warm-up; the device's events are the ones with device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split, ops = {}, 0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0:
            continue
        name = _kernel_name(e.key)
        split[name] = split.get(name, 0.0) + us / 1e3 / calls
        ops += e.count
    return ops / calls, split


def launch_info(kernel: str, b: int, w8: bool, int8: bool):
    """The launch of the persistent kernel at a SHAPES entry, or None on a
    tree whose kernel has no such query."""
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    from frankenstein_tpu_torch.ops.cuda import fused_llama_decode as k5
    if not hasattr(k2, "launch_info"):
        return None
    if kernel == "K2":
        return k2.launch_info(12, b, 64, 768, 12, w8, int8)
    return k5.launch_info(8, b, 64, 1024, 16, 8, 2816, w8, int8)


def phase_split(fn, calls: int = 5):
    """One call's ms in products, attention, rows and barrier waits, and the
    attention's own split (q / k / v, scores, softmax and AV, output: its
    first warp's view), each the mean over the CTAs of the persistent
    kernel's %globaltimer stamps (``fused_decode.STAMPS``), averaged over
    ``calls`` calls; None on a tree without the stamps."""
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    if not hasattr(k2, "STAMPS"):
        return None
    slots = k2.STAMP_SLOTS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k2.STAMPS = torch.zeros(slots * sms * k2.knob_values()[0],
                            dtype=torch.int64, device="cuda")
    try:
        total = torch.zeros(slots, dtype=torch.float64, device="cuda")
        for _ in range(calls):
            k2.STAMPS.zero_()
            fn()
            grid = k2.STAMPS.view(-1, slots)
            grid = grid[grid.sum(1) > 0]
            total += grid.double().mean(0)
        ms = (total / calls / 1e6).tolist()
    finally:
        k2.STAMPS = None
    out = dict(zip(k2.STAMP_NAMES, ms))
    # the attention's total is its phase mark plus its sub-steps' marks
    out["attention"] += sum(out[k] for k in k2.STAMP_NAMES[4:])
    return out


def profile_shapes(card: str) -> None:
    for kernel, b, w8, int8 in SHAPES:
        fn = case(kernel, b, w8, int8)
        ms = per_call_ms(fn)
        ops, split = kernel_split(fn)
        busy = sum(split.values())
        print(json.dumps({
            "kernel": kernel, "batch": b,
            "weights": "w8a16" if w8 else "bf16",
            "cache": "int8" if int8 else "bf16", "ms_per_token": ms,
            "device_ops_per_call": ops, "device_ms_per_call": busy,
            "gap_ms": ms - busy,
            "kernels_ms": dict(sorted(split.items(),
                                      key=lambda kv: -kv[1])),
            "phase_split_ms": phase_split(fn),
            "launch": launch_info(kernel, b, w8, int8),
            "card": card}), flush=True)


def _setting_ms(fns: dict, repeats: int) -> dict:
    """{setting: fn} timed in turns whose order flips each round:
    {setting: (median, min, max) ms a call}."""
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(repeats):
        for key in (order if r % 2 == 0 else order[::-1]):
            times[key].append(per_call_ms(fns[key], iters=10, warmup=1))
    out = {}
    for key, ms in times.items():
        s = sorted(ms)
        out[key] = (s[len(s) // 2], s[0], s[-1])
    return out


def sweep_shapes(card: str, repeats: int) -> None:
    from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
    base = dict(k2.TUNING)
    knobs = {"ctas_per_sm": [1, 2], "ring": [1, 2, 3, 4, 6],
             "items": [132, 264, 528], "n_chunk": [8, 16, 32]}
    for kernel, b, w8, int8 in SHAPES:
        fn = case(kernel, b, w8, int8)
        settings = {"production": dict(base)}
        for knob, values in knobs.items():
            for v in values:
                if v != base[knob]:
                    settings[f"{knob}={v}"] = dict(base, **{knob: v})

        def runner(cfg):
            def run():
                k2.TUNING.update(cfg)
                return fn()
            return run

        outs = {}
        for key, cfg in settings.items():
            k2.TUNING.update(cfg)
            outs[key] = fn()[0].float().clone()
        timed = _setting_ms({k: runner(c) for k, c in settings.items()},
                            repeats)
        k2.TUNING.update(base)
        print(json.dumps({
            "kernel": kernel, "batch": b,
            "weights": "w8a16" if w8 else "bf16",
            "cache": "int8" if int8 else "bf16", "production": base,
            "ms": timed,
            "max_abs_diff": {k: float((o - outs["production"]).abs().max())
                             for k, o in outs.items()},
            "card": card}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("profile", "sweep"))
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    card = _card()
    if args.what == "profile":
        profile_shapes(card)
    else:
        sweep_shapes(card, args.repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
