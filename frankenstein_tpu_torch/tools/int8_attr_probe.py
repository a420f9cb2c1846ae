"""Where does the time of int8 QK scores (K10's math) go?

The Hopper counterpart of the JAX package's ``tools/int8_attr_probe.py``.
Each variant is a compile-time mode of the mma.sync kernel K10 ran before
its wgmma redesign (``ops/cuda/slab_probe.py``,
``csrc/slab_rope_attention.cu``; production K10 is
``csrc/slab_rope_attention_int8.cu``) on the same unrotated inputs, as the
JAX probe omits RoPE:

  bf16                the bf16 reference (attn_probe's ``kernel``)
  int8_dots_only      cast-only codes round(8x), the int8 QK product, raw
                      int32 scores to bf16 straight into PV: no softmax
  int8_full           K10: its K pre-pass, Q quantized per (row, head),
                      int32 scores dequantized with both scales, softmax
  int8_cheap_dequant  K10's codes, the epilogue a convert times the score
                      scale only (no s_q, s_k): prices the scale multiplies
  int8_noquant        cast-only codes, no max reductions in Q or the
                      pre-pass: prices the absmax chains

An int8 variant's ``_ms`` is its K pre-pass and kernel, ``_kernel_ms`` the
kernel alone; the other keys are attn_probe's. It runs at P=256, the
flagship's slab and the JAX tool's ``BLOCK``.

Run on a card (B=128, H=8, T=6144, D=32):

    python -m frankenstein_tpu_torch.tools.int8_attr_probe [n_iters]
        [--batch 128] [--device cuda|cpu]

``--device cpu`` runs the plain twins once each at T=2048, batch 1;
without a GPU and without it the tool exits non-zero.
"""

from __future__ import annotations

import json

from frankenstein_tpu_torch.tools import attn_probe
from frankenstein_tpu_torch.utils.device import cli_device

BLOCK = 256
VARIANTS = ("bf16", "int8_dots_only", "int8_full", "int8_cheap_dequant",
            "int8_noquant")


def main(argv=None) -> dict:
    args = attn_probe.parse(
        argv, "python -m frankenstein_tpu_torch.tools.int8_attr_probe",
        block=False)
    res = attn_probe.probe(VARIANTS, args.n_iters, block=BLOCK,
                           batch=args.batch, t=args.t,
                           device=cli_device(args.device))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
