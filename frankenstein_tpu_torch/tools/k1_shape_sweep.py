"""Hold K1's (or, with ``--int8``, K10's) forward shapes against their
neighbours on the card.

Each candidate shape of ``FwdOf`` in ``csrc/slab_rope_attention_fwd.cu``
(``Int8Of`` in ``csrc/slab_rope_attention_int8.cu``: consumer warpgroups,
key tile, CTAs an SM) is compiled into a library of its own: the source
with that line rewritten, built with the port's nvcc flags
(``ops/cuda/build.py``), one nvcc per candidate, all started together,
into the git-ignored ``build/k1_sweep/``. Then every candidate of a
head_dim runs K1 (its pre-pass and its forward; K10: its Q pre-pass and
its forward on the production K pre-pass's codes) at the flagship
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
    python -m frankenstein_tpu_torch.tools.k1_shape_sweep --int8
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

from frankenstein_tpu_torch.ops.cuda import build

# int8 -> (source, its shape line, the line's template, the forward
# kernel's name and pass type, the C entry point)
KINDS = {
    False: (build.CSRC_DIR / "slab_rope_attention_fwd.cu",
            re.compile(r"using FwdOf = FwdPass<D, [^;]*;"),
            "using FwdOf = FwdPass<D, {}, {}, {}, MASKED>;",
            ("slab_rope_attn_fwd_wgmma", "FwdPass"),
            "fk_slab_rope_attention_fwd"),
    True: (build.CSRC_DIR / "slab_rope_attention_int8.cu",
           re.compile(r"using Int8Of = Int8Pass<D, [^;]*;"),
           "using Int8Of = Int8Pass<D, {}, {}, {}, MASKED>;",
           ("slab_rope_attn_fwd_int8_wgmma", "Int8Pass"),
           "fk_slab_rope_attention_fwd_int8"),
}
# head_dim -> candidates (consumer warpgroups, key tile, CTAs an SM), the
# production shape first
CANDIDATES = {
    32: [(2, 64, 2), (2, 64, 1), (2, 64, 3), (3, 64, 1), (1, 64, 4),
         (2, 128, 1)],
    64: [(3, 64, 1), (2, 64, 1), (4, 64, 1), (3, 128, 1), (2, 128, 1),
         (2, 64, 2)],
}
T, E = 6144, 256


def _tag(d: int, shape: tuple, int8: bool = False) -> str:
    return (f"{'int8_' if int8 else ''}d{d}_wg{shape[0]}_bn{shape[1]}"
            f"_ctas{shape[2]}")


def _compile(jobs: dict, int8: bool = False) -> dict:
    """{tag: (head_dim, shape)} -> {tag: (library path, ptxas output)}:
    the rewritten sources compiled together."""
    source, line, template = KINDS[int8][:3]
    out_dir = build.BUILD_DIR / "k1_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    if len(line.findall(text)) != 1:
        raise RuntimeError(f"{source.name}: {line.pattern} not found once")
    procs = {}
    for tag, (_, (nwg, bn, ctas)) in jobs.items():
        src = out_dir / f"{tag}.cu"
        src.write_text(line.sub(template.format(nwg, bn, ctas), text))
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


def _load(path, int8: bool = False):
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entry = KINDS[int8][4]
    fwd, occ = getattr(lib, entry), getattr(lib, entry + "_occupancy")
    fwd.argtypes = [p] * (10 if int8 else 9) + [i] * 5 + [f, p]
    fwd.restype = i
    occ.argtypes = [i] * 3 + [ctypes.POINTER(i)] * 2
    occ.restype = i
    return lib


def _spills(log: str, d: int, int8: bool = False) -> int:
    """Spill bytes (stores + loads) ptxas reports for the production
    forward kernels of head_dim ``d`` (the library also holds the other
    head_dim's, and the probe modes' instances, MODE > 0)."""
    kernel, pass_type = KINDS[int8][3]
    production = re.compile(rf"{pass_type}ILi{d}E(?:Li\d+E){{3}}Lb[01]ELi0EE")
    total, inside = 0, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line and bool(production.search(line))
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if inside and found:
            total += int(found.group(1)) + int(found.group(2))
    return total


def _occupancy(lib, d: int, p: int, int8: bool = False) -> tuple:
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, KINDS[int8][4] + "_occupancy")(
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
    ap.add_argument("--int8", action="store_true",
                    help="K10's forward (Int8Of) instead of K1's (FwdOf)")
    args = ap.parse_args(argv)
    int8 = args.int8
    if not torch.cuda.is_available():
        print("k1_shape_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    jobs = {_tag(d, s, int8): (d, s) for d in args.head_dim
            for s in CANDIDATES[d]}
    built = _compile(jobs, int8)
    libs = {tag: _load(lib, int8) for tag, (lib, _) in built.items()}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for d in args.head_dim:
        h = E // d
        tags = [_tag(d, s, int8) for s in CANDIDATES[d]]
        cos, sin = rope.folded_tables(
            rope.build_rope_cache(d, T, device=dev), 1)
        for p in args.slab:
            for b in args.batch:
                q, k, v = (torch.randn(b, T, E, generator=gen, device=dev)
                           .to(torch.bfloat16) for _ in range(3))
                out = torch.empty_like(q)
                lse = torch.empty(b, h, T, device=dev)
                if int8:   # K (codes, scales) and Q (codes, scales)
                    kc, ksc = k1.rope_quantize_k(k, cos, sin, n_heads=h)
                    wa = torch.empty(q.shape, dtype=torch.int8, device=dev)
                    wb = torch.empty_like(lse)
                    first = (q, kc, ksc, v, cos, sin, wa, wb)
                else:      # rotated q and k
                    wa, wb = torch.empty_like(q), torch.empty_like(q)
                    first = (q, k, v, cos, sin, wa, wb)
                ptrs = [x.data_ptr() for x in (*first, out, lse)]

                def launch(lib):
                    rc = getattr(lib, KINDS[int8][4])(
                        *ptrs, b, T, h, d, p, 1.0 / d ** 0.5, stream)
                    if rc != 0:
                        raise RuntimeError(f"forward launch: CUDA error {rc}")

                want = k1.slab_rope_attention(q, k, v, cos, sin, n_heads=h,
                                              tok_per_time=p,
                                              qk_int8=int8)[0]
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
                    "kernel": "K10" if int8 else "K1",
                    "head_dim": d, "P": p, "B": b, "T": T, "E": E,
                    "card": torch.cuda.get_device_name(0),
                    "ms": {tag: sorted(v)[len(v) // 2]
                           for tag, v in ms.items()},
                    "range_ms": {tag: [min(v), max(v)]
                                 for tag, v in ms.items()},
                    "max_abs_diff_vs_production": diff}), flush=True)
                del q, k, v, wa, wb, out, lse, first
    print(json.dumps({"occupancy": {
        tag: {"regs_ctas": {p: _occupancy(libs[tag], jobs[tag][0], p, int8)
                            for p in args.slab},
              "spill_bytes": _spills(built[tag][1], jobs[tag][0], int8)}
        for tag in libs}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
