"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` file under ``frankenstein_tpu_torch/csrc`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into ONE shared library with a plain C
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib) -> None:
    """argtypes/restype of every C entry point (pointers and the stream are
    c_void_p, so ctypes never truncates them to 32 bits)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fk_slab_rope_attention_fwd.argtypes = (
        [p] * 7 + [i] * 5 + [f, p])
    lib.fk_slab_rope_attention_fwd.restype = i
    lib.fk_fused_decode_blocks.argtypes = (
        [p] * 6                     # x_in, x_out, x_res, h, hh, workspace
        + [p] * 16                  # 12 weight arrays + 4 scales
        + [p] * 2                   # k_cache, v_cache
        + [i] * 7                   # L, B, S, E, H, length, w_int8
        + [p])                      # stream
    lib.fk_fused_decode_blocks.restype = i
    lib.fk_fused_decode_workspace_bytes.argtypes = [i, i]
    lib.fk_fused_decode_workspace_bytes.restype = ctypes.c_longlong
    lib.fk_error_string.argtypes = [i]
    lib.fk_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"libfk_kernels_{_digest()}.so"
        if not target.exists():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(s) for s in _sources()]]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            (BUILD_DIR / "build.log").write_text(" ".join(cmd) + "\n"
                                                 + build_log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (rc={proc.returncode}):\n"
                                   f"{build_log[-4000:]}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        _declare(lib)
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().fk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
