"""The readings the correctness limits are set from, at a cell's own size,
many seeds in one process (the benchmark's own runs do not run this).

    python3 -m portbench.readings --workload <cell> --seeds 1 2 3 \\
        [--control] [--fault token|half|reorder] [--requests N]

For each seed it builds the program and the cell's inputs afresh and
prints one JSON line, each side's numbers judged by the run's own
comparison against the cell's limits, with its ``correct``:

- serving: the program's served tokens (and beam scores) over
  ``--requests`` requests of the cell's load, a sample of their sentences
  judged against the float32 reference; with ``--control`` the control
  (the reference one step below the served precision, ``reference/
  lowp.py``) serves the same windows itself and is judged alike;
- training: the program's numbers over the cell's first steps, and with
  ``--control`` the control's (the reference at lower precision, followed
  for the same steps), each against the float32 reference.

``--fault`` breaks the timed path underneath first (``token``: one
produced token of every sentence altered; ``half``: half of each batch
left out, the rest standing for it; ``reorder``: the beam cache's reorder
(K3) swaps each sentence's first two beams), to read what a fault gives.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from portbench import device as device_lib
from portbench import run as run_lib
from portbench.reference import lowp

HERE = Path(__file__).resolve().parent


def plant(fault: str, kind: str, put=setattr) -> None:
    """Break the program's timed path in place (for this process), each
    replacement made through ``put(owner, name, value)``."""
    from frankenstein_tpu_torch.decode import sampling
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.train import trainer
    if fault == "token" and kind == "serve":
        for name in ("_beam_advance", "_pick"):
            orig = getattr(sampling, name)

            def altered(*args, _orig=orig, _name=name, **kwargs):
                if _name == "_pick":
                    return (_orig(*args, **kwargs) + 1) % 50257
                args = list(args)
                if args[4] == 3:             # step i: one token a sentence
                    args[3] = (args[3] + 1) % 50257
                return _orig(*args, **kwargs)
            put(sampling, name, altered)
    elif fault == "reorder" and kind == "serve":
        orig = sampling._reorder

        def swapped(model, cache, flat_idx, group=0):
            if group > 1:
                rows = flat_idx.reshape(-1, group).clone()
                rows[:, [0, 1]] = rows[:, [1, 0]]
                flat_idx = rows.reshape(-1)
            return orig(model, cache, flat_idx, group)
        put(sampling, "_reorder", swapped)
    elif fault == "half" and kind == "serve":
        orig = Franky.encode

        def half(self, x, date_info=None):
            out = orig(self, x[:(x.shape[0] + 1) // 2], date_info)
            return out.repeat(2, 1, 1)[:x.shape[0]]
        put(Franky, "encode", half)
    elif fault == "half" and kind == "train":
        orig = trainer.loss_and_grads

        def half(state, batch, config, *args, **kwargs):
            n = batch[0].shape[0] // 2
            return orig(state, tuple(a[:n] for a in batch),
                        config.replace(grad_accum=max(config.grad_accum
                                                      // 2, 1)),
                        *args, **kwargs)
        put(trainer, "loss_and_grads", half)
    else:
        raise SystemExit(f"no fault {fault!r} for a {kind} cell")


def judged(checks: dict) -> dict:
    """A side's numbers beside their limits, and its ``correct`` by the
    run's own rule."""
    return {"correct": run_lib.is_correct(checks),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}


def serve_readings(spec, generator, seed: int, requests: int,
                   control: bool, device: str = "cuda") -> dict:
    import torch
    dev = torch.device(device)
    model, predict, shapes = generator.build(spec, seed, device)
    pool = generator.make_pool(spec, seed, device)
    cap = generator.Capture(model)
    slots = [i % len(pool) for i in range(requests)]
    try:
        for s in slots:
            predict(pool[s])
        served, scores = cap.served(len(slots))
    finally:
        cap.close()
    del predict, model, cap
    device_lib.free(dev)
    chosen = generator.sample(spec, seed, served)
    x, toks, score = generator.reference_inputs(spec, pool, slots, served,
                                                scores, chosen, device)
    params = generator.reference_params(spec, seed, shapes, device)
    out = {"program": judged(generator.judge(spec, params, x, toks, score))}
    if control:
        c_toks, c_score = generator.control(spec, seed, params, x)
        out["control"] = judged(generator.judge(spec, params, x, c_toks,
                                                c_score))
    return out


def train_readings(spec, generator, seed: int, control: bool,
                   device: str = "cuda") -> dict:
    """Each side's three numbers (with the leaf or step that sets each),
    and its ``correct`` on the numbers the cell gives a limit."""
    import torch
    dev = torch.device(device)
    rig = generator.setup(spec, seed, device)
    try:
        prog = generator.program_readings(rig, spec, seed, device)
    finally:
        rig.loader.close()
    shapes, pool = rig.shapes, rig.pool
    del rig
    device_lib.free(dev)
    limits = spec.traffic["limits"]
    side = lambda got: dict(judged({k: (v[0], limits[k])
                                    for k, v in got.items() if k in limits}),
                            gaps=got)
    t0 = time.perf_counter()
    with device_lib.exact_f32():
        ref = generator.reference_readings(spec, seed, device, shapes, pool)
        ref_s = time.perf_counter() - t0
        out = {"program": side(generator.gaps(prog, ref))}
        if control:
            low = generator.reference_readings(spec, seed, device, shapes,
                                               pool, lowp.LowPrecision())
            out["control"] = side(generator.gaps(low, ref))
    out["reference_s"] = ref_s
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("token", "half", "reorder"))
    ap.add_argument("--requests", type=int, default=8)
    args = ap.parse_args(argv)
    run_lib.use_local_caches()
    import torch
    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA device", file=sys.stderr)
        return 2
    spec = run_lib.load_spec(HERE.parent, args.workload)
    generator = run_lib.load_module(HERE / "generators"
                                    / f"{spec.traffic['generator']}.py")
    kind = "serve" if hasattr(generator, "Capture") else "train"
    if args.fault:
        plant(args.fault, kind)
    for seed in args.seeds:
        if kind == "serve":
            got = serve_readings(spec, generator, seed, args.requests,
                                 args.control)
        else:
            got = train_readings(spec, generator, seed, args.control)
        print(json.dumps({"workload": spec.name, "seed": seed,
                          "fault": args.fault, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
