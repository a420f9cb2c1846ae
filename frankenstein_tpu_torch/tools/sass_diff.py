"""Do two versions of a CUDA source compile their kernels to the same SASS?

Compiles OLD and NEW with the port's own nvcc flags (``ops/cuda/build.py``,
``sm_90a``) into cubins under the git-ignored ``build/``, dumps each with
``cuobjdump -sass``, splits the dump into functions and compares every
function of OLD with the function of NEW of the same mangled name,
instruction by instruction. The anonymous namespace's two hashes, which
differ between any two files (the second also changed when a file lost
an external function), are taken out of names and instructions; so are
what the dump sets by the rest of the cubin: the column padding (to its
widest instruction) and the numbers of the branch labels (counted across
it), renumbered from 0 in each function. A
``--map PATTERN=REPLACEMENT`` (a Python regex substitution, applied
in turn) renames OLD's functions first, for a template that gained
parameters; a ``--removed PATTERN`` (a Python regex) names OLD functions
that NEW drops on purpose, each ``removed`` where NEW lacks it. One JSON
line on stdout: per OLD function ``same``, ``differs`` (with the count of
differing lines), ``missing`` or ``removed``, and how many functions only
NEW has. Exits 1 unless every OLD function is ``same`` or ``removed``.

Run on a machine with the CUDA toolkit, e.g. for K1's forward, whose pass
type gained the probes' MODE, against an older copy of its source::

    python -m frankenstein_tpu_torch.tools.sass_diff OLD.cu \\
        frankenstein_tpu_torch/csrc/slab_rope_attention_fwd.cu \\
        --map '(FwdPassI(?:Li\\d+E){4}Lb[01]E)=\\1Li0E'

or for K10's K pre-pass, which moved into K10's source from one that
held the mma.sync probe kernels (the file's name is in the symbols)::

    python -m frankenstein_tpu_torch.tools.sass_diff OLD.cu \\
        frankenstein_tpu_torch/csrc/slab_rope_attention_int8.cu \\
        --map '_ZN\\d+22_slab_rope_attention_cu_=_ZN6027_slab_rope_attention_int8_cu_' \\
        --removed 'slab_rope_attn_fwdILi32ELb'

or for K7 dense and K6 after a change to their shared source (K7 slab's
instances, a mode of the same passes, count among NEW's own)::

    python -m frankenstein_tpu_torch.tools.sass_diff OLD.cu \\
        frankenstein_tpu_torch/csrc/flash_attention_dense.cu
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

from frankenstein_tpu_torch.ops.cuda import build

ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_|(?<=_cu_)[0-9a-f]{8}")
LABEL = re.compile(r"\.L_x_\d+")


def canonical(body: list) -> list:
    """A function's dump lines with each run of blanks one space and its
    branch labels numbered from 0 in order of appearance."""
    labels = {}
    number = lambda m: labels.setdefault(m.group(0), f".L_x_{len(labels)}")
    return [LABEL.sub(number, " ".join(line.split())) for line in body]


def sass(src: Path, workdir: Path) -> dict:
    """{mangled name without the anonymous hash: [instruction lines]} of
    ``src`` compiled as the port builds it (headers from ``csrc/``)."""
    nvcc = Path(build._nvcc())
    cubin = workdir / (src.stem + ".cubin")
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-Xptxas", "-v", "-Xcompiler", "-fPIC")]
    subprocess.run([str(nvcc), *flags, "-cubin", "-I", str(src.parent),
                    "-I", str(build.CSRC_DIR), "-o", str(cubin), str(src)],
                   check=True)
    dump = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                           str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    funcs, name = {}, None
    for line in dump.splitlines():
        line = ANON.sub("", line).strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            funcs[name] = []
        elif name is not None and line:
            funcs[name].append(line)
    return {name: canonical(body) for name, body in funcs.items()}


def compare(old: dict, new: dict, maps, removed=None) -> dict:
    result = {}
    for name, body in old.items():
        renamed = name
        for pattern, repl in maps:
            renamed = re.sub(pattern, repl, renamed)
        if renamed not in new:
            gone = removed is not None and re.search(removed, name)
            result[name] = "removed" if gone else "missing"
            continue
        other = new[renamed]
        diff = sum(a != b for a, b in zip(body, other)) + abs(
            len(body) - len(other))
        result[name] = "same" if diff == 0 else f"differs ({diff} lines)"
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m frankenstein_tpu_torch.tools.sass_diff",
        description=__doc__.split("\n\n")[0])
    p.add_argument("old", type=Path)
    p.add_argument("new", type=Path)
    p.add_argument("--map", action="append", default=[],
                   help="PATTERN=REPLACEMENT renaming OLD's functions")
    p.add_argument("--removed", default=None,
                   help="PATTERN of OLD functions NEW drops on purpose")
    args = p.parse_args(argv)
    maps = [m.split("=", 1) for m in args.map]
    out = build.BUILD_DIR / "sass_diff"
    for side in ("old", "new"):
        (out / side).mkdir(parents=True, exist_ok=True)
    old = sass(args.old.resolve(), out / "old")
    new = sass(args.new.resolve(), out / "new")
    result = compare(old, new, maps, args.removed)
    matched = sum(s not in ("missing", "removed") for s in result.values())
    ok = all(s in ("same", "removed") for s in result.values())
    print(json.dumps({"functions": result, "new_only": len(new) - matched,
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
