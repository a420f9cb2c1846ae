"""Where does the time of int8 QK scores (K10's wgmma forward) go?

The Hopper counterpart of the JAX package's ``tools/int8_attr_probe.py``.
Each variant runs K10's K and Q pre-passes without the rotation (as the
JAX probe omits RoPE), then a compile-time mode of K10's forward
(``csrc/slab_rope_attention_int8.cu``, ``ops/cuda/slab_probe.py``), on the
same unrotated inputs:

  bf16                the bf16 reference (attn_probe's ``kernel``: K1's
                      forward instance, no pre-pass)
  int8_dots_only      cast-only codes round(8x), the int8 QK product, raw
                      int32 scores to bf16 straight into PV: no softmax
  int8_full           K10: its K pre-pass, its Q pre-pass (Q quantized per
                      (row, head)), the production forward: int32 scores
                      dequantized with both scales, softmax
  int8_cheap_dequant  K10's codes, the scores a convert times the score
                      scale only (no s_q, s_k): prices the scale loads and
                      multiplies
  int8_noquant        cast-only codes, no max reductions in either
                      pre-pass: prices the absmax chains

An int8 variant's ``_ms`` is its two pre-passes and its forward,
``_kernel_ms`` the forward alone; the other keys are attn_probe's. On the
card ``k10_ms`` times production K10 on the same inputs with the rope
tables (its pre-passes rotate), the yardstick of ``int8_full_ms``, in
turns with the variants. It runs
at P=256, the flagship's slab and the JAX tool's ``BLOCK``.

Run on a card (B=128, H=8, T=6144, D=32):

    python -m frankenstein_tpu_torch.tools.int8_attr_probe [n_iters]
        [--batch 128] [--device cuda|cpu]

``--device cpu`` runs the plain twins once each at T=2048, batch 1;
without a GPU and without it the tool exits non-zero.
"""

from __future__ import annotations

import functools
import json

from frankenstein_tpu_torch.ops.cuda import slab_attention as k1
from frankenstein_tpu_torch.tools import attn_probe
from frankenstein_tpu_torch.utils.device import cli_device

BLOCK = 256
VARIANTS = ("bf16", "int8_dots_only", "int8_full", "int8_cheap_dequant",
            "int8_noquant")


def k10_yardsticks(q, k, v) -> dict:
    """``k10``: production K10 (its K and Q pre-passes with the rotation,
    then its forward) on the probe's inputs and the rope tables, timed in
    turns with the modes."""
    cos, sin = attn_probe.rope_tables(q.shape[1], q.device)
    return {"k10": functools.partial(
        k1.slab_rope_attention, q, k, v, cos, sin, n_heads=attn_probe.H,
        tok_per_time=BLOCK, qk_int8=True)}


def main(argv=None) -> dict:
    args = attn_probe.parse(
        argv, "python -m frankenstein_tpu_torch.tools.int8_attr_probe",
        block=False)
    device = cli_device(args.device)
    res = attn_probe.probe(
        VARIANTS, args.n_iters, block=BLOCK, batch=args.batch, t=args.t,
        device=device,
        yardsticks=k10_yardsticks if device.type == "cuda" else None)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
