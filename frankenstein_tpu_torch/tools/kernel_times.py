"""Time K9, K10 (K1 beside K10), K6, K8 and K7 slab at the main path's
shapes, through the wrappers every checkout of the port has, so two trees
can be compared in one call on one card.

- K9 (``fused_mlp.fused_norm_swiglu``, LayerNorm): the encoder's [B, 6144,
  256] with hidden 1024 at each batch, and the Perceiver's [128, 32, 256]
  with hidden 512.
- K10 (``slab_attention.slab_rope_attention(qk_int8=True)``: its K and Q
  pre-passes and its forward) and K1 at B in the batches, T=6144, H=8,
  D=32, P=256, at the qk_int8 tests' activation scale (0.5).
- K6 (``flash_attention.flash_attention`` and ``flash_attention_bwd``,
  mode positions): the MAE encoder's attention over the 1536 of 6144
  tokens ``masking_indices`` keeps (ratio 0.75), their slab ids at P=256,
  H=8, D=32, at each batch; the forward and the backward (its dq and dk/dv
  passes) each on their own.
- K8 (``lm_head_topk.lm_head_topk``): GPT-2 124M's head, E=768, V=50304,
  k=10, at each of ``--k8-batch``.
- K7 slab (``flash_attention.flash_attention`` and ``flash_attention_bwd``,
  mode slab): T=6144, H=8, D=32, P=256 at each of ``--k7-batch``, the
  forward and the backward each on their own.

For K6, K8 and K7 slab a second line gives each kernel's device time a
call by name, from ``torch.profiler`` over ``--launches`` calls.

Each time is CUDA events around ``--launches`` launches back to back after
a warm-up, the median of ``--repeats`` such turns; one JSON line per
kernel and shape with the card's name. Run it with the package to time
first on the path, e.g. from the root of another checkout::

    PYTHONPATH=. python /path/to/frankenstein_tpu_torch/tools/kernel_times.py

or in this one as ``python -m frankenstein_tpu_torch.tools.kernel_times``.
"""

from __future__ import annotations

import argparse
import json
import sys


def _median_ms(fn, launches: int, repeats: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[len(times) // 2]


def _device_ms(fn, calls: int) -> dict:
    """Device time a call of each kernel ``fn`` launches, by kernel name
    (torch.profiler over ``calls`` calls after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0 and ev.count >= calls:
            out[ev.key[:80]] = us / calls / 1e3
    return out


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[2, 32, 128])
    ap.add_argument("--launches", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--tag", default="", help="a label for the lines")
    ap.add_argument("--k8-batch", type=int, nargs="+",
                    default=[8, 32, 128, 160])
    ap.add_argument("--k7-batch", type=int, nargs="+", default=[2, 32])
    ap.add_argument("--kernels", nargs="+", default=["K9", "K10", "K6"],
                    choices=["K9", "K10", "K6", "K8", "K7slab"],
                    help="which to time (K10 brings K1 beside it)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 1
    from frankenstein_tpu_torch.models.brainformer import masking_indices
    from frankenstein_tpu_torch.ops import rope
    from frankenstein_tpu_torch.ops.cuda import flash_attention as k67
    from frankenstein_tpu_torch.ops.cuda import fused_mlp as k9
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    card = torch.cuda.get_device_name(0)
    time = lambda fn: _median_ms(fn, args.launches, args.repeats)
    e = 256
    k9_shapes = [(b, 6144, 1024) for b in args.batch] + [(128, 32, 512)]
    for b, t, hidden in k9_shapes if "K9" in args.kernels else []:
        x = rnd(b, t, e).to(torch.bfloat16)
        nw, nb = 1.0 + 0.1 * rnd(e), 0.1 * rnd(e)
        w1, w3 = ((rnd(hidden, e) / e ** 0.5).to(torch.bfloat16)
                  for _ in range(2))
        w2 = (rnd(e, hidden) / hidden ** 0.5).to(torch.bfloat16)
        ms = time(lambda: k9.fused_norm_swiglu(x, nw, nb, w1, w3, w2))
        print(json.dumps({"tag": args.tag, "kernel": "K9", "B": b, "T": t,
                          "E": e, "hidden": hidden, "ms": ms,
                          "tflops": 6 * b * t * e * hidden / ms / 1e9,
                          "card": card}), flush=True)
        del x, w1, w3, w2
    t, h, d, p = 6144, 8, 32, 256
    cos, sin = rope.folded_tables(rope.build_rope_cache(d, t, device=dev), 1)
    kw = dict(n_heads=h, tok_per_time=p)
    for b in args.batch if "K10" in args.kernels else []:
        q, k, v = ((0.5 * rnd(b, t, h * d)).to(torch.bfloat16)
                   for _ in range(3))
        for name, on in (("K10", True), ("K1", False)):
            ms = time(lambda: k1.slab_rope_attention(q, k, v, cos, sin,
                                                     qk_int8=on, **kw))
            print(json.dumps({"tag": args.tag, "kernel": name, "B": b,
                              "T": t, "H": h, "D": d, "P": p, "ms": ms,
                              "card": card}), flush=True)
        del q, k, v
    for b in args.batch if "K6" in args.kernels else []:
        _, kept = masking_indices(gen, b, t, 0.75)
        sid = (kept // p).to(torch.int32).contiguous()
        n = kept.shape[1]
        q, k, v, dout = (rnd(b, n, h * d).to(torch.bfloat16)
                         for _ in range(4))
        kw = dict(n_heads=h, mode="positions", tok_per_time=0, slab_ids=sid)
        out, lse = k67.flash_attention(q, k, v, **kw)
        pairs = int((sid[:, None, :] <= sid[:, :, None]).sum())
        for name, fn in (
                ("K6 fwd", lambda: k67.flash_attention(q, k, v, **kw)),
                ("K6 bwd", lambda: k67.flash_attention_bwd(
                    q, k, v, out, lse, dout, **kw))):
            print(json.dumps({"tag": args.tag, "kernel": name, "B": b,
                              "N": n, "of": t, "H": h, "D": d, "P": p,
                              "pairs": pairs, "ms": time(fn),
                              "card": card}), flush=True)
            print(json.dumps({"tag": args.tag, "kernel": name, "B": b,
                              "device_ms": _device_ms(fn, args.launches),
                              "card": card}), flush=True)
        del q, k, v, dout, out, lse
    e, v, k = 768, 50304, 10
    for b in args.k8_batch if "K8" in args.kernels else []:
        x = rnd(b, e).to(torch.bfloat16)
        ln_w, ln_b = 1.0 + 0.1 * rnd(e), 0.1 * rnd(e)
        wte = (0.02 * rnd(v, e)).to(torch.bfloat16)
        fn = lambda: k8.lm_head_topk(x, ln_w, ln_b, wte, k=k)
        print(json.dumps({"tag": args.tag, "kernel": "K8", "B": b, "E": e,
                          "V": v, "k": k, "ms": time(fn),
                          "device_ms": _device_ms(fn, args.launches),
                          "card": card}), flush=True)
        del x, wte
    kw = dict(n_heads=h, mode="slab", tok_per_time=p)
    for b in args.k7_batch if "K7slab" in args.kernels else []:
        q, k_, v_, dout = ((0.5 * rnd(b, t, h * d)).to(torch.bfloat16)
                           for _ in range(4))
        out, lse = k67.flash_attention(q, k_, v_, **kw)
        for name, fn in (
                ("K7 slab fwd", lambda: k67.flash_attention(q, k_, v_, **kw)),
                ("K7 slab bwd", lambda: k67.flash_attention_bwd(
                    q, k_, v_, out, lse, dout, **kw))):
            print(json.dumps({"tag": args.tag, "kernel": name, "B": b,
                              "T": t, "H": h, "D": d, "P": p, "ms": time(fn),
                              "device_ms": _device_ms(fn, args.launches),
                              "card": card}), flush=True)
        del q, k_, v_, dout, out, lse
    return 0


if __name__ == "__main__":
    sys.exit(main())
