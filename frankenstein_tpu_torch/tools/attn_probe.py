"""Where does the time of K1's wgmma slab-attention forward go?

The Hopper counterpart of the JAX package's ``tools/attn_probe.py``. Each
variant is a compile-time mode of K1's forward
(``csrc/slab_rope_attention_fwd.cu``, ``ops/cuda/slab_probe.py``) with one
component removed, timed on the same unrotated inputs, with no rotation
pre-pass:

  kernel     the production K1 forward instance itself, on unrotated q
             and k: the reference point
  dots_only  the QK and PV products only: no mask, max, exp, sum or rescale
  no_kbd     V read K-major from its tile instead of through the
             transpose-B bit (the step that plays the TPU's block-diagonal
             K staging; values wrong, timing only)
  no_mask    the unmasked production instance at any P (the slab mask
             dropped)
  mask_all   the mask on every visited tile (K1 masks only the tiles that
             cross a warpgroup's first slab, which is what ``mask_last``
             priced)
  exp2       an alias of ``kernel`` (``aliases`` in the output): K1 already
             folds log2(e) into one FFMA before ex2

plus three references the port never calls on its path: ``rope``
(production K1 on the same inputs with the rope tables: its rotation
pre-pass, then the ``kernel`` instance, so ``rope_ms - kernel_ms`` prices
the pre-pass; ``prep_ms`` times the pre-pass alone), ``sdpa``
(``scaled_dot_product_attention`` with the bool slab mask, the library
yardstick) and ``matmul`` (a 4096^2 bf16 ``torch.matmul``, the card's
practical dense-product ceiling, as the JAX tool's ``xla_dot``).

Per variant: ``<variant>_ms`` (the median of ``n_iters`` single calls
between CUDA events after a warm-up, timed in turns with the other
variants and with ``rope`` and ``prep``, so that a drift of the card's
clock falls on all alike) and its range, ``_issued_tflops``
(the products the schedule issues: 64-key tiles visited x 2 products of
2*64*64*D per 64-row warpgroup) and ``_useful_tflops`` (slab-visible pairs
x 4*D). One stderr JSON line per variant and yardstick, then one stdout
JSON line of all results.

Run on a card (the JAX tool's shape B=128, H=8, T=6144, D=32):

    python -m frankenstein_tpu_torch.tools.attn_probe [n_iters]
        [--block 8|256] [--batch 128] [--device cuda|cpu]

``--block`` is the slab length P (tokens per time step): 256 is the
flagship's, 8 the JAX tool's own. ``--device cpu`` runs the plain twins
once each at T=2048 (``--batch`` 1 by default) and reports no times;
without a GPU and without it the tool exits non-zero.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys

import torch

from frankenstein_tpu_torch.ops import rope
from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
from frankenstein_tpu_torch.ops.cuda import slab_probe as sp
from frankenstein_tpu_torch.utils.device import cli_device

B, H, T, D = 128, 8, 6144, 32
CPU_BATCH, CPU_T = 1, 2048
VARIANTS = ("kernel", "dots_only", "no_kbd", "no_mask", "mask_all", "exp2")
SEED = 0


def inputs(batch: int, t: int, device, seed: int = SEED):
    """Unrotated q, k, v [batch, t, H*D] bf16, standard normal from a
    seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(batch, t, H * D, generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(3)]


def in_turns(fns: dict, n_iters: int) -> dict:
    """name -> (median, min, max) ms of ``n_iters`` single calls of each
    thunk in ``fns``, each between CUDA events, after one warm-up call
    each, in turns whose order flips every round: a drift of the card's
    clock falls on every name alike."""
    for fn in fns.values():
        fn()
    names = list(fns)
    ms = {name: [] for name in names}
    for i in range(n_iters):
        for name in (names if i % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end))
    return {name: (sorted(m)[len(m) // 2], min(m), max(m))
            for name, m in ms.items()}


def time_ms(fn, n_iters: int) -> tuple:
    """(median, min, max) ms of ``n_iters`` single calls of fn(), each
    between CUDA events, after one warm-up call."""
    return in_turns({"fn": fn}, n_iters)["fn"]


def work(batch: int, t: int, p: int) -> dict:
    """Operations of one call over ``batch`` x H heads: ``issued`` (the
    tiles the forward's warpgroups visit, two products of 2*64*64*D each)
    and ``useful`` (slab-visible (query, key) pairs, 4*D each)."""
    heads = batch * H
    pairs = int(sp.slab_ends(t, p).sum())
    return {"issued": heads * sp.visited_tiles(t, p) * 2 * (
                2 * sp.WG_ROWS * sp.BK * D),
            "useful": heads * pairs * 4 * D}


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None


def probe(variants, n_iters: int, *, block: int, batch: int, t: int,
          device, yardsticks=None) -> dict:
    """Each variant's results (module docstring) on ``device``: CUDA times
    the modes in turns (``in_turns``) with the thunks ``yardsticks(q, k,
    v)`` returns (name -> thunk, on the same inputs; ``<name>_ms``); the
    CPU runs each twin once and times nothing. An int8 mode's ``_ms`` is
    its K and Q pre-passes and its forward; ``_kernel_ms`` the forward
    alone on the pre-passes' codes."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    q, k, v = inputs(batch, t, device)
    ops = work(batch, t, block)
    res = {"device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "card": _card() if cuda else None, "batch": batch, "t": t,
           "heads": H, "head_dim": D, "block": block,
           "variants": list(variants),
           "aliases": {name: sp.ALIASES[name] for name in variants
                       if name in sp.ALIASES}}
    kw = dict(n_heads=H, tok_per_time=block)
    if not cuda:
        for variant in variants:
            res[f"{variant}_ms"] = None
            res[f"{variant}_finite"] = (
                bool(all(torch.isfinite(x).all() for x in
                         sp.slab_attention_probe(q, k, v, variant=variant,
                                                 **kw)))
                if variant in sp.TWINS else None)
            print(json.dumps({variant: None}), file=sys.stderr, flush=True)
        return res
    fns = {}
    for variant in variants:
        fns[variant] = functools.partial(sp.slab_attention_probe, q, k, v,
                                         variant=variant, **kw)
        if sp.is_int8(variant):
            fns[f"{variant}_kernel"] = functools.partial(
                sp.slab_attention_probe,
                sp.probe_quantize_q(q, n_heads=H, variant=variant),
                sp.probe_quantize_k(k, n_heads=H, variant=variant), v,
                variant=variant, with_prepass=False, **kw)
    extra = yardsticks(q, k, v) if yardsticks else {}
    times = in_turns({**fns, **extra}, n_iters)
    for variant in variants:
        ms, lo, hi = times[variant]
        res[f"{variant}_ms"] = ms
        res[f"{variant}_range_ms"] = [lo, hi]
        res[f"{variant}_issued_tflops"] = ops["issued"] / ms / 1e9
        res[f"{variant}_useful_tflops"] = ops["useful"] / ms / 1e9
        if sp.is_int8(variant):
            res[f"{variant}_kernel_ms"] = times[f"{variant}_kernel"][0]
        print(json.dumps({variant: ms}), file=sys.stderr, flush=True)
    for name in extra:
        ms, lo, hi = times[name]
        res.update({f"{name}_ms": ms, f"{name}_range_ms": [lo, hi]})
        print(json.dumps({name: ms}), file=sys.stderr, flush=True)
    return res


def rope_tables(t: int, dev):
    """The folded rope tables [t, D] f32 the encoder gives K1 and K10."""
    return rope.folded_tables(rope.build_rope_cache(D, t, device=dev), 1)


def k1_yardsticks(q, k, v, *, block: int) -> dict:
    """``rope`` (production K1 on the probe's inputs and the rope tables:
    its rotation pre-pass, then the ``kernel`` instance) and ``prep`` (the
    pre-pass alone), timed in turns with the modes."""
    cos, sin = rope_tables(q.shape[1], q.device)
    return {"rope": functools.partial(k1.slab_rope_attention, q, k, v, cos,
                                      sin, n_heads=H, tok_per_time=block),
            "prep": functools.partial(k1.slab_rope_fwd_prep, q, k, cos, sin,
                                      n_heads=H)}


def references(n_iters: int, *, block: int, batch: int, t: int) -> dict:
    """``sdpa`` (one ``scaled_dot_product_attention`` call with the bool
    slab mask) and ``matmul`` (4096^2 bf16): the library yardsticks, on
    the card."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    q, k, v = inputs(batch, t, dev)
    res = {}
    heads = [x.reshape(batch, t, H, D).transpose(1, 2) for x in (q, k, v)]
    i = torch.arange(t, device=dev)
    mask = (i[None, :] // block) <= (i[:, None] // block)
    res["sdpa_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        *heads, attn_mask=mask), n_iters)[0]
    del heads, mask
    a, b = (torch.randn(4096, 4096, device=dev).to(torch.bfloat16)
            for _ in range(2))
    ms = time_ms(lambda: torch.matmul(a, b), max(8 * n_iters, 16))[0]
    res.update(matmul_ms=ms, matmul_tflops=2 * 4096 ** 3 / ms / 1e9)
    for name in ("sdpa", "matmul"):
        print(json.dumps({name: res[f"{name}_ms"]}), file=sys.stderr,
              flush=True)
    return res


def parse(argv, prog: str, block: bool):
    p = argparse.ArgumentParser(prog=prog, description=__doc__.split(
        "\n\n")[0])
    p.add_argument("n_iters", nargs="?", type=int, default=6)
    if block:
        p.add_argument("--block", type=int, default=256, choices=[8, 256],
                       help="slab length P: 256 (the flagship) or 8 (the "
                            "JAX tool's own)")
    p.add_argument("--batch", type=int, default=None,
                   help=f"default {B} on cuda, {CPU_BATCH} on cpu")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; exits without a usable GPU) or cpu")
    args = p.parse_args(argv)
    cpu = args.device == "cpu"
    if args.batch is None:
        args.batch = CPU_BATCH if cpu else B
    args.t = CPU_T if cpu else T
    return args


def main(argv=None) -> dict:
    args = parse(argv, "python -m frankenstein_tpu_torch.tools.attn_probe",
                 block=True)
    device = cli_device(args.device)
    cuda = device.type == "cuda"
    res = probe(VARIANTS, args.n_iters, block=args.block, batch=args.batch,
                t=args.t, device=device,
                yardsticks=functools.partial(k1_yardsticks, block=args.block)
                if cuda else None)
    if cuda:
        res.update(references(args.n_iters, block=args.block,
                              batch=args.batch, t=args.t))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
