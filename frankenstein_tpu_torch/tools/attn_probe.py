"""Where does the time of the mma.sync slab-attention forward go?

The Hopper counterpart of the JAX package's ``tools/attn_probe.py``. Each
variant is a compile-time mode of the mma.sync kernel that K1 and K10 ran
before their wgmma redesigns (``ops/cuda/slab_probe.py``,
``csrc/slab_rope_attention.cu``), with one component removed, timed on the
same unrotated inputs; production K1 (``csrc/slab_rope_attention_fwd.cu``)
and K10 (``csrc/slab_rope_attention_int8.cu``) are not among them:

  kernel     K1's math on that kernel, without the rotation: the
             reference point
  dots_only  the QK and PV products only: no mask, max, exp, sum or rescale
  no_kbd     V staged row-major, not transposed (the step that plays the
             TPU's block-diagonal K staging; values wrong, timing only)
  no_mask    the slab mask dropped
  mask_all   the mask on every visited tile (the kernel masks only the
             tiles that cross a warp's first slab, which is what
             ``mask_last`` priced)
  exp2       log2(e) folded into the score scale, exp2f

plus three references the port never calls on its path: ``rope``
(production K1, the wgmma design, with the rope tables), ``sdpa``
(``scaled_dot_product_attention`` with the bool slab mask, the library
yardstick) and ``matmul`` (a 4096^2 bf16 ``torch.matmul``, the card's
practical dense-product ceiling, as the JAX tool's ``xla_dot``).

Per variant: ``<variant>_ms`` (the median of ``n_iters`` single calls
between CUDA events, after a warm-up) and its range, ``_issued_tflops``
(the products the schedule issues: 64-key tiles visited x 2 products of
2*16*64*D per 16-row warp) and ``_useful_tflops`` (slab-visible pairs x
4*D). One stderr JSON line per variant as it finishes, then one stdout JSON
line of all results.

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


def time_ms(fn, n_iters: int) -> tuple:
    """(median, min, max) ms of ``n_iters`` single calls of fn(), each
    between CUDA events, after one warm-up call."""
    fn()
    ms = []
    for _ in range(n_iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    ms.sort()
    return ms[len(ms) // 2], ms[0], ms[-1]


def work(batch: int, t: int, p: int) -> dict:
    """Operations of one call over ``batch`` x H heads: ``issued`` (the
    tiles the kernel's warps visit, two products of 2*16*64*D each) and
    ``useful`` (slab-visible (query, key) pairs, 4*D each)."""
    heads = batch * H
    pairs = int(sp.slab_ends(t, p).sum())
    return {"issued": heads * sp.visited_tiles(t, p) * 2 * (2 * 16 * 64 * D),
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
          device) -> dict:
    """Each variant's results (module docstring) on ``device``: CUDA times
    the kernel's modes; the CPU runs each twin once and times nothing. An
    int8 mode's ``_ms`` is its pre-pass and kernel; ``_kernel_ms`` the
    kernel alone on the pre-pass's codes."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    q, k, v = inputs(batch, t, device)
    ops = work(batch, t, block)
    res = {"device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "card": _card() if cuda else None, "batch": batch, "t": t,
           "heads": H, "head_dim": D, "block": block,
           "variants": list(variants)}
    for variant in variants:
        run = lambda: sp.slab_attention_probe(
            q, k, v, n_heads=H, tok_per_time=block, variant=variant)
        if not cuda:
            res[f"{variant}_ms"] = None
            res[f"{variant}_finite"] = (
                bool(all(torch.isfinite(x).all() for x in run()))
                if variant in sp.TWINS else None)
        else:
            ms, lo, hi = time_ms(run, n_iters)
            res[f"{variant}_ms"] = ms
            res[f"{variant}_range_ms"] = [lo, hi]
            res[f"{variant}_issued_tflops"] = ops["issued"] / ms / 1e9
            res[f"{variant}_useful_tflops"] = ops["useful"] / ms / 1e9
            if sp.is_int8(variant):
                codes = sp.probe_quantize_k(k, n_heads=H, variant=variant)
                alone = lambda: sp.slab_attention_probe(
                    q, codes, v, n_heads=H, tok_per_time=block,
                    variant=variant, with_prepass=False)
                res[f"{variant}_kernel_ms"] = time_ms(alone, n_iters)[0]
        print(json.dumps({variant: res[f"{variant}_ms"]}), file=sys.stderr,
              flush=True)
    return res


def references(n_iters: int, *, block: int, batch: int, t: int) -> dict:
    """``rope`` (production K1 on the same inputs and the rope tables),
    ``sdpa`` (one ``scaled_dot_product_attention`` call with the bool slab
    mask) and ``matmul`` (4096^2 bf16): the yardsticks, on the card."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    q, k, v = inputs(batch, t, dev)
    cos, sin = rope.folded_tables(rope.build_rope_cache(D, t, device=dev),
                                  1)
    res = {}
    ms, lo, hi = time_ms(lambda: k1.slab_rope_attention(
        q, k, v, cos, sin, n_heads=H, tok_per_time=block), n_iters)
    res.update(rope_ms=ms, rope_range_ms=[lo, hi])
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
    for name in ("rope", "sdpa", "matmul"):
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
    res = probe(VARIANTS, args.n_iters, block=args.block, batch=args.batch,
                t=args.t, device=device)
    if device.type == "cuda":
        res.update(references(args.n_iters, block=args.block,
                              batch=args.batch, t=args.t))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
