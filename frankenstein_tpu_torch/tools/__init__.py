"""Measurement tools of the port: the packed-attention probes
(``attn_probe``, ``int8_attr_probe``), Hopper counterparts of the JAX
package's ``tools/attn_probe.py`` and ``tools/int8_attr_probe.py``."""
