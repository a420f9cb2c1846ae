"""One run of one benchmark cell of ``frankenstein_tpu_torch`` on NVIDIA
GPUs.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Everything is found by name from
``BENCHMARK.json``: the cell's configuration (its ``file``), its traffic
mix (``portbench/traffic/<traffic>.json``), the generator it names
(``portbench/generators/<generator>.py``), and each per-layer metric's reader
(``portbench/metrics/<metric>.py``). ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, read from a
profiled slice after the same measured window. The last line of standard
output is the result; the last lines of standard error, and the result's
last key, give every number the correctness check compared with its limit.

A run needs a CUDA device (as many as the cell asks for) and exits non-zero
without one; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "frankenstein_tpu")


@dataclass
class Spec:
    """A cell as ``BENCHMARK.json`` and its data files describe it; its
    generator and readers are found under ``root/portbench``."""
    root: Path
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # portbench/traffic/<traffic>.json
    end_to_end: list      # metric entries this cell reports
    per_layer: list


def load_spec(root: Path, cell: str) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    w = work[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    mine = lambda m: cell in m.get("workloads", [cell])
    traffic = root / "portbench" / "traffic" / f"{w['traffic']}.json"
    return Spec(root, cell, int(w["chips"]),
                json.loads((root / conf["file"]).read_text()),
                json.loads(traffic.read_text()),
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def load_module(path: Path):
    """The module at ``path`` (a file named after a metric or generator, which
    may hold dots), imported under a name of its own."""
    name = "portbench._by_name." + path.stem.replace(".", "_")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def use_local_caches() -> None:
    """Compiler caches at fixed paths inside the checkout, so that only a
    checkout's first run compiles (the port's own CUDA library is built
    once under ``frankenstein_tpu_torch/build/``, keyed on its sources)."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             device: str, t_start: float) -> dict:
    """Drive the cell's traffic through its generator and read its
    metrics. Returns the generator's outcome with ``metrics`` filled for
    this mode."""
    here = spec.root / "portbench"
    generator = load_module(here / "generators"
                            / f"{spec.traffic['generator']}.py")
    out = generator.run(spec, seed, seconds, trace, device, t_start)
    if trace:
        values = {}
        for m in spec.per_layer:
            reader = load_module(here / "metrics" / f"{m['name']}.py")
            v = reader.read(out["context"])
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {m["name"]: {"value": float(out["end_to_end"][m["name"]]),
                              "unit": m["unit"]}
                  for m in spec.end_to_end if m["name"] in out["end_to_end"]}
    out["metrics"] = values
    return out


def power_limit_w() -> float | None:
    """The card's power limit in watts (nvidia-smi), or None."""
    try:
        text = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(text[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def loaded_banned() -> list:
    """Loaded modules whose whole top-level name is one of ``BANNED``."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in BANNED)


def is_correct(checks: dict) -> bool:
    """Every number compared is within its limit (and there is one)."""
    return bool(checks) and all(v <= lim for v, lim in checks.values())


def result_line(out: dict, spec: Spec, device: dict) -> dict:
    checks = out["checks"]
    line = {"correct": is_correct(checks), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_local_caches()
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; a run needs one and does not "
              "fall back to the CPU", file=sys.stderr)
        return 2
    spec = load_spec(HERE.parent, args.workload)
    if torch.cuda.device_count() < spec.chips:
        print(f"portbench: {spec.name} needs {spec.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    banned = loaded_banned()
    if banned:
        print(f"portbench: the run loaded {banned}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": spec.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"]),
              "power_limit_w": power_limit_w()}
    if args.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["trace_window_s"]
    line = result_line(out, spec, device)
    print(f"portbench: the reference took {out['reference_s']:.1f} s after "
          f"the window", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
