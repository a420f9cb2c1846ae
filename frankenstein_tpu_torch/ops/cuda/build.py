"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` file under ``frankenstein_tpu_torch/csrc`` (with the
``*.cuh`` headers they share) is compiled by
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, and the objects are linked into ONE shared library with a plain C
interface, loaded with ``ctypes``. The build runs at first use, never at
import, into ``frankenstein_tpu_torch/build/`` (listed in ``.gitignore``),
and is keyed on a hash of the sources and flags: a changed source builds a
new library, an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_seconds = None      # wall time of the nvcc run this process did, if any


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib) -> None:
    """argtypes/restype of every C entry point (pointers and the stream are
    c_void_p, so ctypes never truncates them to 32 bits)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fk_slab_rope_attention_fwd.argtypes = (
        [p] * 9                     # q k v cos sin qr kr out lse
        + [i] * 5 + [f, p])         # B T H D P, scale, stream
    lib.fk_slab_rope_attention_fwd.restype = i
    lib.fk_slab_rope_attn_fwd_prep.argtypes = (
        [p] * 6                     # q k cos sin qr kr
        + [i] * 4 + [p])            # B T H D, stream
    lib.fk_slab_rope_attn_fwd_prep.restype = i
    lib.fk_slab_rope_attention_fwd_occupancy.argtypes = (
        [i] * 3 + [ctypes.POINTER(i)] * 2)   # pass D P, regs ctas
    lib.fk_slab_rope_attention_fwd_occupancy.restype = i
    lib.fk_slab_rope_k_quant.argtypes = (
        [p] * 6                     # k cos sin amax k8 ks
        + [i] * 4 + [p])            # B T H D, stream
    lib.fk_slab_rope_k_quant.restype = i
    lib.fk_slab_rope_q_quant.argtypes = (
        [p] * 5                     # q cos sin q8 qs
        + [i] * 4 + [p])            # B T H D, stream
    lib.fk_slab_rope_q_quant.restype = i
    lib.fk_slab_rope_attention_fwd_int8.argtypes = (
        [p] * 10                    # q k8 ks v cos sin q8 qs out lse
        + [i] * 5 + [f, p])         # B T H D P, scale, stream
    lib.fk_slab_rope_attention_fwd_int8.restype = i
    lib.fk_slab_rope_attention_fwd_int8_occupancy.argtypes = (
        [i] * 3 + [ctypes.POINTER(i)] * 2)   # pass D P, regs ctas
    lib.fk_slab_rope_attention_fwd_int8_occupancy.restype = i
    lib.fk_slab_attention_probe.argtypes = (
        [p] * 5                     # q k v out lse
        + [i] * 5 + [f]             # B T H D P, scale
        + [i, p])                   # variant, stream
    lib.fk_slab_attention_probe.restype = i
    lib.fk_slab_attention_probe_int8.argtypes = (
        [p] * 10                    # q k v amax q8 qs k8 ks out lse
        + [i] * 5 + [f]             # B T H D P, scale
        + [i] * 2 + [p])            # variant stages, stream
    lib.fk_slab_attention_probe_int8.restype = i
    for name in ("fk_slab_attention_probe_occupancy",
                 "fk_slab_attention_probe_int8_occupancy"):
        getattr(lib, name).argtypes = (
            [i] * 2 + [ctypes.POINTER(i)] * 2)   # variant P, regs ctas
        getattr(lib, name).restype = i
    lib.fk_lm_head_topk.argtypes = (
        [p] * 11                    # x ln_w ln_b wte h cand part bar vals
                                    # idx logz
        + [i] * 5 + [f, p])         # B E V k G, eps, stream
    lib.fk_lm_head_topk.restype = i
    lib.fk_lm_head_topk_info.argtypes = [i] * 3 + [ctypes.POINTER(i)]
    lib.fk_lm_head_topk_info.restype = i   # B k G, out[6]
    lib.fk_slab_rope_attention_bwd.argtypes = (
        [p] * 14                    # q k v cos sin out dout lse qr kr delta
                                    # dq dk dv
        + [i] * 5 + [f, p])         # B T H D P, scale, stream
    lib.fk_slab_rope_attention_bwd.restype = i
    lib.fk_slab_rope_attn_bwd_prep.argtypes = (
        [p] * 9                     # q k cos sin out dout qr kr delta
        + [i] * 4 + [p])            # B T H D, stream
    lib.fk_slab_rope_attn_bwd_prep.restype = i
    lib.fk_slab_rope_attention_bwd_occupancy.argtypes = (
        [i] * 3 + [ctypes.POINTER(i)] * 2)   # pass D P, regs ctas
    lib.fk_slab_rope_attention_bwd_occupancy.restype = i
    lib.fk_flash_attention_fwd.argtypes = (
        [p] * 6                     # q k v sid out lse
        + [i] * 6 + [f, p])         # B T H D mode P, scale, stream
    lib.fk_flash_attention_fwd.restype = i
    lib.fk_flash_attention_bwd.argtypes = (
        [p] * 11                    # q k v sid out dout lse delta dq dk dv
        + [i] * 6 + [f, p])         # B T H D mode P, scale, stream
    lib.fk_flash_attention_bwd.restype = i
    lib.fk_flash_attention_occupancy.argtypes = (
        [i] * 3 + [ctypes.POINTER(i)] * 2)   # mode pass D, regs ctas
    lib.fk_flash_attention_occupancy.restype = i
    lib.fk_fused_decode_blocks.argtypes = (
        [p] * 5                     # x_in, x_out, workspace, barrier, stamps
        + [p] * 16                  # 12 weight arrays + 4 scales
        + [p] * 4                   # k_cache, v_cache, k_scale, v_scale
        + [i] * 8                   # L, B, S, E, H, length, w_int8, kv_int8
        + [i] * 4                   # ctas_per_sm, ring, items, n_chunk
        + [p])                      # stream
    lib.fk_fused_decode_blocks.restype = i
    lib.fk_fused_decode_workspace_bytes.argtypes = [i] * 8
    lib.fk_fused_decode_workspace_bytes.restype = ctypes.c_longlong
    lib.fk_fused_decode_info.argtypes = [i] * 11 + [ctypes.POINTER(i)]
    lib.fk_fused_decode_info.restype = i
    lib.fk_fused_llama_decode_blocks.argtypes = (
        [p] * 5                     # x_in, x_out, workspace, barrier, stamps
        + [p] * 4                   # cos, sin, norm1_w, norm2_w
        + [p] * 14                  # 7 weight arrays + 7 scales
        + [p] * 4                   # k_cache, v_cache, k_scale, v_scale
        + [i] * 8                   # L, B, S, E, H, KV, F, length
        + [f, i, i]                 # eps, w_int8, kv_int8
        + [i] * 4                   # ctas_per_sm, ring, items, n_chunk
        + [p])                      # stream
    lib.fk_fused_llama_decode_blocks.restype = i
    lib.fk_fused_llama_decode_workspace_bytes.argtypes = [i] * 10
    lib.fk_fused_llama_decode_workspace_bytes.restype = ctypes.c_longlong
    lib.fk_fused_llama_decode_smem_bytes.argtypes = [i] * 4
    lib.fk_fused_llama_decode_smem_bytes.restype = ctypes.c_longlong
    lib.fk_fused_llama_decode_info.argtypes = [i] * 13 + [ctypes.POINTER(i)]
    lib.fk_fused_llama_decode_info.restype = i
    lib.fk_beam_reorder.argtypes = (
        [p] * 3                     # k_cache, v_cache, parent_local
        + [i] * 4                   # L, groups, W, row bytes
        + [p])                      # stream
    lib.fk_beam_reorder.restype = i
    lib.fk_fused_norm_swiglu.argtypes = (
        [p] * 7                     # x nw nb w1 w3 w2 out
        + [i] * 4                   # R E hidden kind
        + [f, p])                   # eps, stream
    lib.fk_fused_norm_swiglu.restype = i
    lib.fk_fused_norm_swiglu_occupancy.argtypes = (
        [i] * 4 + [ctypes.POINTER(i)] * 2)   # E kind nwg R, regs ctas
    lib.fk_fused_norm_swiglu_occupancy.restype = i
    lib.fk_moe_route.argtypes = (
        [p] * 11                    # h gate bias chosen weights pos rows
                                    # ends ends_sum counts arrived
        + [i] * 6                   # n d e k norm sms
        + [f, p])                   # scaling, stream
    lib.fk_moe_route.restype = i
    lib.fk_moe_route_groups.argtypes = [i] * 4    # n d e sms
    lib.fk_moe_route_groups.restype = i
    lib.fk_moe_combine.argtypes = (
        [p] * 4                     # y w pos out
        + [i] * 3 + [p])            # n d k, stream
    lib.fk_moe_combine.restype = i
    lib.fk_error_string.argtypes = [i]
    lib.fk_error_string.restype = ctypes.c_char_p


def _run(cmds, log) -> None:
    """Run the commands in parallel; log them all, raise if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    with open(log, "a") as f:
        for c, out in zip(cmds, outs):
            f.write(" ".join(c) + "\n" + out)
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc={p.returncode}) on "
                               f"{c[-1]}:\n{out[-4000:]}")


def _compile(target: Path) -> None:
    """One nvcc per source, started together, then one link."""
    log = BUILD_DIR / "build.log"
    log.write_text("")
    tag = f"{target.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    nvcc = _nvcc()
    _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
          for o, src in zip(objs, _sources())], log)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]], log)
    for o in objs:
        o.unlink()
    os.replace(tmp, target)


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"libfk_kernels_{_digest()}.so"
        if not target.exists():
            t0 = time.perf_counter()
            _compile(target)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        _declare(lib)
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().fk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
