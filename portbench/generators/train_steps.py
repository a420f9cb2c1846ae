"""Training steps back to back: ``train/trainer.py:train_step`` at the
configuration's batch and precision, fed by the port's loader
(``data/loader.py`` ``to_device`` inside ``prefetch``, as
``run_train_model`` feeds it), with no eval or checkpoint in the window.

Set-up builds the model (f32 parameters, bf16 compute under
``mixed_precision``) and its AdamW state through the program's own
``make_optimizer``, loads the benchmark's weights (drawn from the seed) and
makes a pool of host batches from the seed, each row different. The first
``check_steps`` steps are the warm-up and also the steps the correctness
check follows; the window then runs steps for ``seconds`` and counts every
sample of every step it ran, over the time until the device finished them.

Correctness: the plain float32 reference (``reference/<model>.py``,
``reference/optim.py``) follows the first ``ref_steps`` of those steps on
the same rows (the MAE's masks derived again from the trainer's seed and
step). Three numbers are read, each relative, and those the traffic gives
a limit are compared: the worst step's loss; the worst leaf's norm of the
first gradient as AdamW got it (its first moment after one update over
1 - b1); the worst leaf's norm of the change of the parameters after
``ref_steps`` updates. A leaf's gap is taken
against the reference's norm of that leaf or of the median leaf, whichever
is larger. Parameters whose reference gradient is under a thousandth of the
median leaf's (per element: of its root-mean-square element) move under
AdamW by round-off alone, as the key part of GPT-2's ``c_attn.bias`` does
under softmax, and are left out of the change.
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass


from portbench import device as device_lib
from portbench import profile, programs, weights
from portbench.reference import optim
from portbench.reference.blocks import FP32

TRACE_CALLS = 2
FLAT_GRAD = 1e-3     # a gradient under this share of the median leaf's is
                     # round-off (under softmax): its change is not compared


@dataclass
class Rig:
    """The training step as the window drives it: one state, its feed."""
    state: object
    tcfg: object
    sched: object
    gen: object
    loader: object
    shapes: list
    pool: list            # host batches (tuples of numpy arrays)


def initial_weights(spec, shapes, seed: int, device: str) -> dict:
    """The benchmark's float32 weights for the cell's model."""
    import torch
    _, ref = programs.lookup(spec.config)
    return weights.make(shapes, ref.init_rule, seed, device, torch.float32,
                        ref.n_layer(spec.config["model_config"]))


def setup(spec, seed: int, device: str) -> Rig:
    import torch
    from frankenstein_tpu_torch.config import TrainConfig
    from frankenstein_tpu_torch.data.loader import prefetch, to_device
    from frankenstein_tpu_torch.train import trainer
    cfg, tr = spec.config, spec.traffic
    prog, _ = programs.lookup(cfg)
    tcfg = TrainConfig.from_dict(cfg["train"]).replace(
        batch_size=tr["batch"], grad_accum=tr["grad_accum"], seed=seed,
        mesh_shape=None)
    dtype = torch.bfloat16 if tcfg.mixed_precision else None
    dev = torch.device(device)
    model = prog.build_training(cfg["model_config"], dev, dtype)
    model.remat = tcfg.remat
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    weights.load(model, initial_weights(spec, shapes, seed, device))
    opt, sched = trainer.make_optimizer(tcfg, model)
    state = trainer.TrainState(model, opt)
    pool = prog.training_pool(spec, seed, device)

    def host_batches():
        i = 0
        while True:
            yield pool[i % len(pool)]
            i += 1

    loader = prefetch(to_device(host_batches(), dev))
    return Rig(state, tcfg, sched, torch.Generator(device=dev), loader,
               shapes, pool)


def step(rig: Rig):
    """One optimizer update through the window's own call and feed."""
    from frankenstein_tpu_torch.train import trainer
    return trainer.train_step(rig.state, next(rig.loader), rig.tcfg,
                              rig.sched, rig.gen)


def program_readings(rig: Rig, spec, seed: int, device: str) -> dict:
    """Run the first ``check_steps`` updates and read what the reference
    compares: each step's loss, each leaf's first gradient as AdamW got it,
    each leaf's change after ``ref_steps`` updates."""
    tr = spec.traffic
    named = dict(rig.state.model.named_parameters())
    b1 = rig.tcfg.adam_b1
    losses, grad, change = [], {}, {}
    for s in range(tr["check_steps"]):
        loss, _ = step(rig)
        losses.append(float(loss))
        if s == 0:
            moments = {n: rig.state.optimizer.state.get(p, {}).get(
                "exp_avg") for n, p in named.items()}
            grad = {n: 0.0 if m is None else float(m.norm()) / (1 - b1)
                    for n, m in moments.items()}
        if s + 1 == tr["ref_steps"]:
            w0 = initial_weights(spec, rig.shapes, seed, device)
            change = {n: (p.detach() - w0[n]).cpu()
                      for n, p in named.items()}
            del w0
    return {"loss": losses[:tr["ref_steps"]], "grad": grad,
            "change": change}


def reference_readings(spec, seed: int, device: str, shapes, pool,
                       num=FP32) -> dict:
    """The reference's losses, first gradients (clipped, as AdamW takes
    them) and changes over ``ref_steps`` updates on the same rows."""
    import torch
    cfg, tr = spec.config, spec.traffic
    _, ref = programs.lookup(cfg)
    dev = torch.device(device)
    w0 = initial_weights(spec, shapes, seed, device)
    params = {n: w.clone().requires_grad_() for n, w in w0.items()}
    adam, losses, first = {}, [], {}
    accum = tr["grad_accum"]
    clip = cfg["train"].get("grad_clip", 1.0)
    for s in range(tr["ref_steps"]):
        batch = [torch.as_tensor(a).to(dev) for a in pool[s % len(pool)]]
        total = 0.0
        for part, count in ref.micro_losses(batch, accum, tr["ref_rows"],
                                            seed, s, params,
                                            cfg["model_config"], num):
            part = part / count / accum
            part.backward()
            total += float(part.detach())
        losses.append(total)
        grads = {n: p.grad for n, p in params.items()}
        if s == 0:
            first = {n: g.clamp(-clip, clip).cpu() for n, g in grads.items()}
        with torch.no_grad():
            optim.adamw_update({n: p.data for n, p in params.items()},
                               grads, adam, cfg["train"], s)
        for p in params.values():
            p.grad = None
    change = {n: (p.detach() - w0[n]).cpu() for n, p in params.items()}
    return {"loss": losses, "grad": {n: float(g.norm())
                                     for n, g in first.items()},
            "first": first, "change": change}


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers compared (see the module's docstring)."""
    return {k: v for k, (v, _) in gaps(prog, ref).items()}


def gaps(prog: dict, ref: dict) -> dict:
    """Each number compared with the leaf (or step) that sets it."""
    loss = max((abs(a - b) / abs(b), f"step {i + 1}") for i, (a, b) in
               enumerate(zip(prog["loss"], ref["loss"])))
    med_g = statistics.median(ref["grad"].values())
    grad = max((abs(prog["grad"][n] - g) / max(g, med_g), n)
               for n, g in ref["grad"].items())
    rms = statistics.median(float(g.norm()) / g.numel() ** 0.5
                            for g in ref["first"].values())
    moved = {n: g.abs() >= FLAT_GRAD * rms for n, g in ref["first"].items()}
    norms = {n: (float(prog["change"][n][m].norm()),
                 float(ref["change"][n][m].norm()))
             for n, m in moved.items() if bool(m.any())}
    med_c = statistics.median(r for _, r in norms.values())
    change = max((abs(p - r) / max(r, med_c), n)
                 for n, (p, r) in norms.items())
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def run(spec, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    import torch
    tr = spec.traffic
    dev = torch.device(device)
    rig = setup(spec, seed, device)
    try:
        prog = program_readings(rig, spec, seed, device)
        device_lib.sync(dev)
        device_lib.reset_peak(dev)
        setup_s = time.perf_counter() - t_start
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            loss, _ = step(rig)
            steps += 1
        last = float(loss)
        device_lib.sync(dev)
        window_s = time.perf_counter() - t0
        if not math.isfinite(last):
            raise FloatingPointError(f"non-finite loss {last} in the window")
        peak = device_lib.peak_bytes(dev)
        outcome = {
            "end_to_end": {"setup_s": setup_s,
                           tr.get("throughput_metric", "samples_per_s"):
                               steps * tr["batch"] / window_s,
                           "peak_gib": peak / 2 ** 30},
            "memory_peak_bytes": peak, "attempted": steps, "failed": 0}
        context = {"kind": "train", "config": spec.config, "traffic": tr,
                   "window_s": window_s, "steps": steps,
                   "samples": steps * tr["batch"]}
        if trace:
            got = profile.capture(lambda i: step(rig), TRACE_CALLS)
            context["trace"] = got
            outcome.update(busy_s=got.busy_s, trace_window_s=got.window_s,
                           breakdown=got.breakdown())
        outcome["context"] = context
    finally:
        rig.loader.close()
    shapes, pool = rig.shapes, rig.pool
    del rig
    device_lib.free(dev)
    t_ref = time.perf_counter()
    with device_lib.exact_f32():
        ref = reference_readings(spec, seed, device, shapes, pool)
    outcome["reference_s"] = time.perf_counter() - t_ref
    limits = tr["limits"]
    outcome["checks"] = {k: (v, limits[k])
                         for k, v in compare(prog, ref).items()
                         if k in limits}
    return outcome
