"""Hold K1's forward shapes against their neighbours on the card.

Each candidate shape of ``FwdOf`` in ``csrc/slab_rope_attention_fwd.cu``
(consumer warpgroups, key tile, CTAs an SM) is compiled into a library of
its own: the source with ``FwdOf``'s line rewritten, built with the port's
nvcc flags (``ops/cuda/build.py``), one nvcc per candidate, all started
together, into the git-ignored ``build/k1_sweep/``. Then every candidate
of a head_dim runs K1 (its pre-pass and its forward) at the flagship
encoder's shape (T=6144, E=256; P=256, the unmasked instance, and P=96,
the masked one), at each batch, in turns whose order flips every round:
each turn times ``--launches`` launches back to back between CUDA events.
One JSON line per (head_dim, P, batch): each candidate's median ms a
launch and its range over ``--repeats`` turns, and its output's largest
difference from the production library's on the same inputs; then one
line with each candidate's registers, CTAs an SM and spills. The
production shape is the first candidate of each head_dim.

Run on a machine with the CUDA toolkit and a Hopper card::

    python -m frankenstein_tpu_torch.tools.k1_shape_sweep --batch 2 32
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

from frankenstein_tpu_torch.ops.cuda import build

SOURCE = build.CSRC_DIR / "slab_rope_attention_fwd.cu"
FWD_OF = re.compile(r"using FwdOf = FwdPass<D, [^;]*;")
# head_dim -> candidates (consumer warpgroups, key tile, CTAs an SM), the
# production shape first
CANDIDATES = {
    32: [(2, 64, 2), (2, 64, 1), (2, 64, 3), (3, 64, 1), (1, 64, 4),
         (2, 128, 1)],
    64: [(3, 64, 1), (2, 64, 1), (4, 64, 1), (3, 128, 1), (2, 128, 1),
         (2, 64, 2)],
}
T, E = 6144, 256


def _tag(d: int, shape: tuple) -> str:
    return f"d{d}_wg{shape[0]}_bn{shape[1]}_ctas{shape[2]}"


def _compile(jobs: dict) -> dict:
    """{tag: (head_dim, shape)} -> {tag: (library path, ptxas output)}:
    the rewritten sources compiled together."""
    out_dir = build.BUILD_DIR / "k1_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    if len(FWD_OF.findall(text)) != 1:
        raise RuntimeError(f"{SOURCE.name}: FwdOf's line not found once")
    procs = {}
    for tag, (_, (nwg, bn, ctas)) in jobs.items():
        src = out_dir / f"{tag}.cu"
        src.write_text(FWD_OF.sub(
            f"using FwdOf = FwdPass<D, {nwg}, {bn}, {ctas}, MASKED>;", text))
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
    lib.fk_slab_rope_attention_fwd.argtypes = [p] * 9 + [i] * 5 + [f, p]
    lib.fk_slab_rope_attention_fwd.restype = i
    lib.fk_slab_rope_attention_fwd_occupancy.argtypes = (
        [i] * 3 + [ctypes.POINTER(i)] * 2)
    lib.fk_slab_rope_attention_fwd_occupancy.restype = i
    return lib


def _spills(log: str, d: int) -> int:
    """Spill bytes (stores + loads) ptxas reports for the forward kernels
    of head_dim ``d`` (the library also holds the other head_dim's)."""
    total, inside = 0, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = ("slab_rope_attn_fwd_wgmma" in line
                      and f"FwdPassILi{d}E" in line)
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if inside and found:
            total += int(found.group(1)) + int(found.group(2))
    return total


def _occupancy(lib, d: int, p: int) -> tuple:
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    rc = lib.fk_slab_rope_attention_fwd_occupancy(
        1, d, p, ctypes.byref(regs), ctypes.byref(ctas))
    if rc != 0:
        raise RuntimeError(f"occupancy: CUDA error {rc}")
    return regs.value, ctas.value


def main(argv=None) -> int:
    import torch
    from frankenstein_tpu_torch.ops import rope
    from frankenstein_tpu_torch.ops.cuda import slab_attention as k1

    ap = argparse.ArgumentParser(
        prog="python -m frankenstein_tpu_torch.tools.k1_shape_sweep",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[2, 32])
    ap.add_argument("--slab", type=int, nargs="+", default=[256, 96])
    ap.add_argument("--head-dim", type=int, nargs="+", default=[32, 64],
                    choices=sorted(CANDIDATES))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--launches", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_shape_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    jobs = {_tag(d, s): (d, s) for d in args.head_dim
            for s in CANDIDATES[d]}
    built = _compile(jobs)
    libs = {tag: _load(lib) for tag, (lib, _) in built.items()}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for d in args.head_dim:
        h = E // d
        tags = [_tag(d, s) for s in CANDIDATES[d]]
        cos, sin = rope.folded_tables(
            rope.build_rope_cache(d, T, device=dev), 1)
        for p in args.slab:
            for b in args.batch:
                q, k, v = (torch.randn(b, T, E, generator=gen, device=dev)
                           .to(torch.bfloat16) for _ in range(3))
                qr, kr, out = (torch.empty_like(q) for _ in range(3))
                lse = torch.empty(b, h, T, device=dev)

                def launch(lib):
                    rc = lib.fk_slab_rope_attention_fwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        cos.data_ptr(), sin.data_ptr(), qr.data_ptr(),
                        kr.data_ptr(), out.data_ptr(), lse.data_ptr(), b, T,
                        h, d, p, 1.0 / d ** 0.5, stream)
                    if rc != 0:
                        raise RuntimeError(f"K1 launch: CUDA error {rc}")

                want = k1.slab_rope_attention(q, k, v, cos, sin, n_heads=h,
                                              tok_per_time=p)[0]
                diff = {}
                for tag in tags:
                    launch(libs[tag])
                    torch.cuda.synchronize()
                    diff[tag] = float((out.float() - want.float()).abs()
                                      .max())
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
                        ms[tag].append(start.elapsed_time(end)
                                       / args.launches)
                print(json.dumps({
                    "head_dim": d, "P": p, "B": b, "T": T, "E": E,
                    "card": torch.cuda.get_device_name(0),
                    "ms": {tag: sorted(v)[len(v) // 2]
                           for tag, v in ms.items()},
                    "range_ms": {tag: [min(v), max(v)]
                                 for tag, v in ms.items()},
                    "max_abs_diff_vs_production": diff}), flush=True)
                del q, k, v, qr, kr, out, lse
    print(json.dumps({"occupancy": {
        tag: {"regs_ctas": {p: _occupancy(libs[tag], jobs[tag][0], p)
                            for p in args.slab},
              "spill_bytes": _spills(built[tag][1], jobs[tag][0])}
        for tag in libs}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
