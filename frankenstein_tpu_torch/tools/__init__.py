"""Measurement tools of the port: the packed-attention probes
(``attn_probe``, ``int8_attr_probe``), Hopper counterparts of the JAX
package's ``tools/attn_probe.py`` and ``tools/int8_attr_probe.py``; the
kernels' shape sweeps (``k1_shape_sweep`` for K1 and, with ``--int8``,
K10; ``k9_shape_sweep``), the decode kernels' profile and launch-knob
sweep (``decode_sweep``), K9 / K10 / K1 times through their wrappers in
any checkout (``kernel_times``) and a SASS comparison of two versions of
a source (``sass_diff``)."""
