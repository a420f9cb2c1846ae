"""Hold K9's shapes against their neighbours on the card.

Each candidate of ``MlpOf`` in ``csrc/fused_mlp.cu`` (consumer warpgroups
a CTA, hidden chunk columns, ring stages) is compiled into a library of
its own: the source with ``MlpOf``'s line rewritten to that one shape for
every width and row count, built with the port's nvcc flags
(``ops/cuda/build.py``), one nvcc per candidate, all started together,
into the git-ignored ``build/k9_sweep/``. Then every candidate runs K9
(LayerNorm) at the encoder's shape (T=6144, E=256, hidden 1024) at each
batch and at the Perceiver's ([128, 32, 256], hidden 512), in turns whose
order flips every round: each turn times ``--launches`` launches back to
back between CUDA events. One JSON line per shape: each candidate's median
ms a launch and its range over ``--repeats`` turns, its issued TFLOP/s
(6 R E hidden operations a launch), and its output's largest difference
from the production library's on the same inputs; then one line with each
candidate's registers, CTAs an SM and spills. The production line is the
first candidate.

Run on a machine with the CUDA toolkit and a Hopper card::

    python -m frankenstein_tpu_torch.tools.k9_shape_sweep --batch 2 32 128
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

from frankenstein_tpu_torch.ops.cuda import build

SOURCE = build.CSRC_DIR / "fused_mlp.cu"
MLP_OF = re.compile(r"using MlpOf = MlpPass<E, [^;]*;")
# tag -> MlpOf's right-hand side, the production line first
STAGES = "E == 256 && NWG == 2 ? 3 : 4"
CANDIDATES = {
    "production": f"MlpPass<E, NWG, 32, {STAGES}>",
    "wg2": "MlpPass<E, 2, 32, E == 256 ? 3 : 4>",
    "wg1": "MlpPass<E, 1, 32, 4>",
    "st2": "MlpPass<E, NWG, 32, 2>",
    "wg1_nc64_st2": "MlpPass<E, 1, 64, 2>",
}
E, HIDDEN, T = 256, 1024, 6144
PERCEIVER = (128, 32, 512)   # B, T, hidden


def _compile(tags) -> dict:
    """{tag: (library path, ptxas output)}: the rewritten sources compiled
    together."""
    out_dir = build.BUILD_DIR / "k9_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    if len(MLP_OF.findall(text)) != 1:
        raise RuntimeError(f"{SOURCE.name}: MlpOf's line not found once")
    procs = {}
    for tag in tags:
        src = out_dir / f"{tag}.cu"
        src.write_text(MLP_OF.sub(f"using MlpOf = {CANDIDATES[tag]};", text))
        lib = out_dir / f"lib{tag}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
               str(build.CSRC_DIR), "-o", str(lib), str(src)]
        procs[tag] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag}:\n{log[-4000:]}")
        built[tag] = (lib, log)
    return built


def _load(path):
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fk_fused_norm_swiglu.argtypes = [p] * 7 + [i] * 4 + [f, p]
    lib.fk_fused_norm_swiglu.restype = i
    lib.fk_fused_norm_swiglu_occupancy.argtypes = (
        [i] * 4 + [ctypes.POINTER(i)] * 2)
    lib.fk_fused_norm_swiglu_occupancy.restype = i
    return lib


def _spills(log: str) -> int:
    """Spill bytes (stores + loads) ptxas reports for the E = 256 kernels
    (both norms, both warpgroup counts)."""
    total, inside = 0, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = ("fused_norm_swiglu_wgmma" in line
                      and "MlpPassILi256E" in line)
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if inside and found:
            total += int(found.group(1)) + int(found.group(2))
    return total


def _occupancy(lib, rows: int) -> tuple:
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    rc = lib.fk_fused_norm_swiglu_occupancy(E, 0, 0, rows, ctypes.byref(regs),
                                            ctypes.byref(ctas))
    if rc != 0:
        raise RuntimeError(f"occupancy: CUDA error {rc}")
    return regs.value, ctas.value


def main(argv=None) -> int:
    import torch
    from frankenstein_tpu_torch.ops.cuda import fused_mlp as k9

    ap = argparse.ArgumentParser(
        prog="python -m frankenstein_tpu_torch.tools.k9_shape_sweep",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[2, 32, 128])
    ap.add_argument("--candidates", nargs="+", default=list(CANDIDATES),
                    choices=list(CANDIDATES))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--launches", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k9_shape_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    tags = list(args.candidates)
    built = _compile(tags)
    libs = {tag: _load(lib) for tag, (lib, _) in built.items()}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    shapes = [(b, T, HIDDEN) for b in args.batch] + [PERCEIVER]
    for b, t, hidden in shapes:
        rows = b * t
        x = rnd(rows, E).to(torch.bfloat16)
        nw, nb = 1.0 + 0.1 * rnd(E), 0.1 * rnd(E)
        w1, w3 = ((rnd(hidden, E) / E ** 0.5).to(torch.bfloat16)
                  for _ in range(2))
        w2 = (rnd(E, hidden) / hidden ** 0.5).to(torch.bfloat16)
        out = torch.empty_like(x)

        def launch(lib):
            rc = lib.fk_fused_norm_swiglu(
                x.data_ptr(), nw.data_ptr(), nb.data_ptr(), w1.data_ptr(),
                w3.data_ptr(), w2.data_ptr(), out.data_ptr(), rows, E,
                hidden, k9.KINDS["layernorm"], k9.EPS["layernorm"], stream)
            if rc != 0:
                raise RuntimeError(f"K9 launch: CUDA error {rc}")

        want = k9.fused_norm_swiglu(x, nw, nb, w1, w3, w2)
        diff = {}
        for tag in tags:
            launch(libs[tag])
            torch.cuda.synchronize()
            diff[tag] = float((out.float() - want.float()).abs().max())
        ms = {tag: [] for tag in tags}
        for r in range(args.repeats):
            for tag in (tags if r % 2 == 0 else tags[::-1]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.launches):
                    launch(libs[tag])
                end.record()
                end.synchronize()
                ms[tag].append(start.elapsed_time(end) / args.launches)
        med = {tag: sorted(v)[len(v) // 2] for tag, v in ms.items()}
        print(json.dumps({
            "B": b, "T": t, "E": E, "hidden": hidden,
            "card": torch.cuda.get_device_name(0),
            "ms": med, "range_ms": {tag: [min(v), max(v)]
                                    for tag, v in ms.items()},
            "issued_tflops": {tag: 6 * rows * E * hidden / m / 1e9
                              for tag, m in med.items()},
            "max_abs_diff_vs_production": diff}), flush=True)
        del x, w1, w3, w2, out
    print(json.dumps({"occupancy": {
        tag: {"regs_ctas": {rows: _occupancy(libs[tag], rows)
                            for rows in (2 * T, 32 * T)},
              "spill_bytes": _spills(built[tag][1])}
        for tag in libs}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
