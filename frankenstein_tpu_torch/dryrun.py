"""One training step of every parallel layout over n ranks (the port of the
JAX package's ``dryrun_multichip``, ``__graft_entry__.py``).

  python -m frankenstein_tpu_torch.dryrun --ranks 4 --device cpu   # gloo
  python -m frankenstein_tpu_torch.dryrun --ranks 4                # 4 GPUs

Starts n rank processes (joined through a file in a temporary directory,
NCCL on the cards or gloo on the CPU) that run seven phases on tiny shapes:
DP (the trainer's step over a ("data", "model") mesh of (n, 1)), TP x DP
(the LLaMA's projections split over "model"), DP x PP (GPipe), SP (ring
attention over a "seq" group of n), EP (an MoE layer's experts over
"model"), FSDP (the trainer's step with FSDP2 over "data") and FrankyLlama
TP x DP. Each phase asserts a finite loss and finite gradients and prints
the JAX package's ``ok`` line with its loss. Without ``--device cpu`` it
needs as many GPUs as ranks and exits saying so. A run that outlasts
``--timeout`` seconds (a hung collective) is killed and fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _tiny_franky_cfg():
    from frankenstein_tpu_torch import config as c
    return c.FrankyConfig(
        brain=c.PerceiverConfig(
            encoder=c.MAEConfig(window_size=32, n_electrodes=8, patch_size=8,
                                dim=16, n_layers=2, head_dim=8, hidden_dim=32,
                                n_heads=2, n_kv_heads=2, n_dec_layers=1,
                                decoder_dim=16),
            n_output_tokens=4, output_dim=24, dim=16, n_layers=1, head_dim=8,
            hidden_dim=32, n_heads=2, n_kv_heads=2),
        gpt=c.GPTConfig(block_size=64, vocab_size=512, n_layer=2, n_head=2,
                        n_embd=24),
        max_tokens=8, pad_token_id=511)


def _finite(loss, grads, what: str) -> float:
    loss = float(loss.detach())
    assert np.isfinite(loss), f"{what} loss not finite: {loss}"
    for g in grads:
        g = g.to_local() if hasattr(g, "to_local") else g
        assert g is not None and bool(torch.isfinite(g).all()), \
            f"{what}: a gradient is not finite"
    return loss


def _train_step(n: int, device, fsdp: bool):
    """(loss, gradients, model) of one trainer step of the tiny Franky
    over a (n, 1) mesh."""
    from frankenstein_tpu_torch.config import TrainConfig
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.models.weights import init_franky_
    from frankenstein_tpu_torch.train import trainer
    model = init_franky_(Franky(_tiny_franky_cfg(), device=device), seed=0)
    tcfg = TrainConfig(batch_size=2 * n, learning_rate=1e-3, warmup_iters=0,
                       use_scheduler=False, mesh_shape=(n, 1), fsdp=fsdp,
                       mixed_precision=False)
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.standard_normal((2 * n, 32, 8))
                              .astype(np.float32)).to(device),
             torch.from_numpy(rng.integers(0, 500, (2 * n, 8))).to(device),
             torch.zeros(2 * n, dtype=torch.long, device=device))
    par = trainer.setup_parallel(model, tcfg, device)
    opt, sched = trainer.make_optimizer(tcfg, model)
    state = trainer.TrainState(model, opt, parallel=par)
    gen = torch.Generator(device=device)
    loss = trainer.loss_and_grads(state, batch, tcfg, gen)
    grads = [p.grad for p in model.parameters()]
    trainer.apply_update(state, tcfg, sched)
    return loss, grads, model


def _phases(n: int, device) -> list:
    from frankenstein_tpu_torch import config as c
    from frankenstein_tpu_torch.models.franky import FrankyLlama
    from frankenstein_tpu_torch.models.llama import Llama
    from frankenstein_tpu_torch.models.moe import MoESwiGLU
    from frankenstein_tpu_torch.models.weights import init_franky_llama_
    from frankenstein_tpu_torch.parallel import mesh as mesh_lib
    from frankenstein_tpu_torch.parallel import pipeline as pp
    from frankenstein_tpu_torch.parallel import ring_attention as ra
    from frankenstein_tpu_torch.parallel import sharding as shard_lib
    from torch.distributed.device_mesh import init_device_mesh
    lines = []
    tag = f"dryrun_multichip({n})"

    loss, grads, _ = _train_step(n, device, fsdp=False)
    lines.append(f"{tag}: DP ok, loss={_finite(loss, grads, 'DP'):.4f}")

    mp = 2 if n % 2 == 0 else 1
    mesh2 = mesh_lib.make_mesh((n // mp, mp), device.type)
    data2 = mesh_lib.group_of(mesh2, "data")
    model2 = mesh_lib.group_of(mesh2, "model")
    torch.manual_seed(0)
    lm = Llama(c.tiny_llama_config(), device=device)
    shard_lib.shard_params(lm, model2)
    idx = torch.zeros(2 * (n // mp), 8, dtype=torch.long, device=device)
    with mesh_lib.batch_shard(data2):
        (i,) = mesh_lib.shard_batch((idx,), data2)
        loss = lm(i, targets=i)[0]
    loss.backward()
    lines.append(f"{tag}: TPxDP ({n // mp},{mp}) ok, loss="
                 f"{_finite(loss, [p.grad for p in lm.parameters()], 'TP'):.4f}")

    pp_size = 4 if n % 4 == 0 else 2 if n % 2 == 0 else 1
    dp_size = n // pp_size
    mesh3 = init_device_mesh(device.type, (dp_size, pp_size),
                             mesh_dim_names=("data", pp.STAGE_AXIS))
    stage, data3 = (mesh3[pp.STAGE_AXIS].get_group(),
                    mesh3["data"].get_group())
    prng = np.random.default_rng(0)
    n_layers, e, f = 2 * pp_size, 16, 32
    stacked = {"w1": torch.from_numpy(prng.standard_normal((n_layers, e, f))
                                      * 0.2).float().to(device),
               "w2": torch.from_numpy(prng.standard_normal((n_layers, f, e))
                                      * 0.2).float().to(device)}
    px = torch.from_numpy(prng.standard_normal((4 * dp_size, e))).float() \
        .to(device)
    ptgt = torch.from_numpy(prng.standard_normal((4 * dp_size, e))).float() \
        .to(device)
    local = pp.stage_params(stacked, stage)
    layer = lambda lp, h: h + torch.tanh(h @ lp["w1"]) @ lp["w2"]
    y = pp.pipelined_apply(pp.stage_scan(layer), local, px, 2, stage,
                           data_group=data3)
    loss = torch.mean((y - ptgt) ** 2)
    loss.backward()
    mesh_lib.sum_grads(local.values(), data3)
    lines.append(f"{tag}: DPxPP ({dp_size},{pp_size}) ok, loss="
                 f"{_finite(loss, [g.grad for g in local.values()], 'PP'):.4f}")

    rrng = np.random.default_rng(1)
    qkv = [torch.from_numpy(rrng.standard_normal((2, 8 * n, 2, 8)))
           .float().to(device).requires_grad_(True) for _ in range(3)]
    out = ra.ring_attention_sharded(*qkv, dist.group.WORLD, slab=8)
    loss = torch.mean(out.float() ** 2)
    loss.backward()
    lines.append(f"{tag}: SP ring-attention (seq={n}) ok, loss="
                 f"{_finite(loss, [t.grad for t in qkv], 'SP'):.4f}")

    torch.manual_seed(0)
    moe = MoESwiGLU(16, 32, 2 * mp, k=2, device=device)
    with torch.no_grad():
        for p in moe.parameters():
            p.normal_(0.0, 0.02)
    shard_lib.shard_params(moe, model2, shard_lib.MOE_EP_RULES)
    mx = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, 16))).float().to(device)
    y, aux = moe(mx)
    loss = torch.mean(y ** 2) + 0.01 * aux
    loss.backward()
    lines.append(f"{tag}: EP MoE (experts over model={mp}) ok, loss="
                 f"{_finite(loss, [p.grad for p in moe.parameters()], 'EP'):.4f}")

    loss, grads, model = _train_step(n, device, fsdp=True)
    n_sharded = sum(1 for p in model.parameters()
                    if hasattr(p, "placements") and n > 1)
    assert n == 1 or n_sharded > 0, "FSDP dryrun: no parameter sharded"
    lines.append(f"{tag}: FSDP ({n_sharded} sharded param leaves over "
                 f"data={n}) ok, loss={_finite(loss, grads, 'FSDP'):.4f}")

    lm7 = c.tiny_llama_config(vocab_size=512)
    base = _tiny_franky_cfg().brain
    cfg7 = c.FrankyLlamaConfig(
        brain=base.replace(encoder=base.encoder.replace(n_layers=1),
                           output_dim=lm7.dim),
        lm=lm7, max_tokens=8, pad_token_id=511)
    fl = init_franky_llama_(FrankyLlama(cfg7, device=device), seed=0)
    shard_lib.shard_params(fl, model2)
    rng7 = np.random.default_rng(7)
    b7 = 2 * (n // mp)
    x7 = torch.from_numpy(rng7.standard_normal((b7, 32, 8))).float() \
        .to(device)
    y7 = torch.from_numpy(rng7.integers(0, 512, (b7, 8))).to(device)
    with mesh_lib.batch_shard(data2):
        xs, ys = mesh_lib.shard_batch((x7, y7), data2)
        loss = fl(xs, ys)[0]
    loss.backward()
    lines.append(f"{tag}: FrankyLlama TPxDP ({n // mp},{mp}) ok, loss="
                 f"{_finite(loss, [p.grad for p in fl.parameters()], 'FL'):.4f}")
    return lines


def _rank_main(rank: int, world: int, init: str, device_type: str) -> None:
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    from frankenstein_tpu_torch.parallel.mesh import backend_for
    dist.init_process_group(backend_for(device_type),
                            init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        lines = _phases(world, device)
        if rank == 0:
            print("\n".join(lines), flush=True)
    finally:
        dist.destroy_process_group()


def dryrun(n: int, device_type: str = "cpu", timeout: float = 600.0) -> str:
    """Run the seven phases on ``n`` ranks; returns rank 0's output, raises
    ``RuntimeError`` with every rank's log when a rank fails or the run
    outlasts ``timeout`` seconds."""
    if device_type == "cuda" and torch.cuda.device_count() < n:
        raise SystemExit(f"--ranks {n} on cuda needs {n} GPUs, this machine "
                         f"has {torch.cuda.device_count()}; pass --device "
                         "cpu for gloo ranks on the CPU")
    root = Path(__file__).resolve().parents[1]
    with tempfile.TemporaryDirectory() as tmp:
        logs = [Path(tmp) / f"rank{r}.log" for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "frankenstein_tpu_torch.dryrun", "--rank",
             str(r), "--ranks", str(n), "--init", str(Path(tmp) / "init"),
             "--device", device_type],
            cwd=root, stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
            for r in range(n)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = [log.read_text() for log in logs]
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("dryrun failed:\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode}) ---\n{t[-4000:]}"
            for r, (p, t) in enumerate(zip(procs, texts))))
    return texts[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.ranks, args.init, args.device)
        return 0
    sys.stdout.write(dryrun(args.ranks, args.device, args.timeout))
    return 0


if __name__ == "__main__":
    sys.exit(main())
