"""Rank workers for the port's multi-rank tests on the CPU (gloo).

Imports torch and the port only: the test files start these ranks as
``python -m tests.torch_parallel_workers SUITE RANK WORLD INIT_FILE OUT``
(one process a rank, joined through ``file://INIT_FILE``) and read the JSON
that rank 0 writes to OUT: ``{check: value}``, each value an error to hold
to the test's tolerance or a flag. References from the JAX package reach a
rank as numpy arrays in ``OUT.refs.npz``, written by the test before the
spawn. Each rank also computes the one-rank reference itself (one-device
math is the same on every rank).
"""

from __future__ import annotations

import copy
import json
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.parallel import mesh as mesh_lib
from frankenstein_tpu_torch.parallel import pipeline as pp
from frankenstein_tpu_torch.parallel import ring_attention as ra
from frankenstein_tpu_torch.parallel import sharding as shard_lib

CPU = torch.device("cpu")


def _err(a, b) -> float:
    a = torch.as_tensor(a).detach().float()
    b = torch.as_tensor(b).detach().float()
    return float((a - b).abs().max()) if a.numel() else 0.0


def _rel(a, b) -> float:
    return _err(a, b) / max(float(torch.as_tensor(b).abs().max()), 1e-12)


def tiny_franky_cfg(moe: int = 0, cap: float = 1.25, dropout: float = 0.0):
    return tconfig.FrankyConfig(
        brain=tconfig.PerceiverConfig(
            encoder=tconfig.MAEConfig(window_size=32, n_electrodes=8,
                                      patch_size=8, dim=16, n_layers=1,
                                      head_dim=8, hidden_dim=32, n_heads=2,
                                      n_kv_heads=2, n_dec_layers=1,
                                      decoder_dim=16),
            n_output_tokens=4, output_dim=24, dim=16, n_layers=1, head_dim=8,
            hidden_dim=32, n_heads=2, n_kv_heads=2),
        gpt=tconfig.GPTConfig(block_size=32, vocab_size=300, n_layer=2,
                              n_head=2, n_embd=24, dropout=dropout,
                              moe_experts=moe, moe_k=2, moe_capacity=cap),
        max_tokens=8, pad_token_id=299)


def tiny_batch(b: int = 8, seed: int = 0):
    """(x [b, 32, 8], y [b, 8] with a ragged -100 tail, dates [b])."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, 32, 8)).astype(np.float32))
    y = rng.integers(0, 299, (b, 8))
    for i in range(b):
        y[i, 8 - (i % 4):] = tconfig.IGNORE_INDEX
    return x, torch.from_numpy(y), torch.zeros(b, dtype=torch.long)


def _train_cfg(**kw):
    base = dict(exp_name="t", batch_size=8, max_steps=2, warmup_iters=0,
                use_scheduler=False, mixed_precision=False,
                learning_rate=3e-3)
    return tconfig.TrainConfig(**{**base, **kw})


def _steps(model, tcfg, batch, parallel: bool, steps: int = 2):
    """(losses, model, optimizer) after ``steps`` train steps on ``batch``,
    one-device or over ``tcfg``'s mesh."""
    from frankenstein_tpu_torch.train import trainer
    par = (trainer.setup_parallel(model, tcfg, CPU) if parallel else None)
    opt, sched = trainer.make_optimizer(tcfg, model)
    state = trainer.TrainState(model, opt, parallel=par)
    gen = torch.Generator(device=CPU)
    losses = []
    for _ in range(steps):
        loss, _ = trainer.train_step(state, batch, tcfg, sched, gen)
        losses.append(float(loss))
    return losses, model, opt


def _step_parity(name: str, make_model, batch, **kw) -> dict:
    """One-device steps against the same steps over the mesh: the loss's
    relative error and the largest parameter difference."""
    tcfg = _train_cfg(**kw)
    model = make_model()
    ref = copy.deepcopy(model)
    want, ref, _ = _steps(ref, tcfg.replace(mesh_shape=None, fsdp=False),
                          batch, parallel=False)
    got, model, opt = _steps(model, tcfg, batch, parallel=True)
    state = shard_lib.full_state(model, opt)
    full, ref_sd = state["model"], ref.state_dict()
    # a resume: the full optimizer state back to this rank's parts
    opt.load_state_dict(shard_lib.local_optimizer_state(state["optimizer"],
                                                        opt))
    again = shard_lib.full_state(model, opt)["optimizer"]["state"]
    moments = [(a[k], again[i][k]) for i, a in
               state["optimizer"]["state"].items() for k in a]
    return {f"{name}/loss": max(abs(g - w) / abs(w)
                                for g, w in zip(got, want)),
            f"{name}/params": max(_err(full[k], ref_sd[k]) for k in ref_sd),
            f"{name}/resume": max(_err(a, b) for a, b in moments)}


def _franky(**kw):
    from frankenstein_tpu_torch.models.franky import Franky
    from frankenstein_tpu_torch.models.weights import init_franky_
    return init_franky_(Franky(tiny_franky_cfg(**kw)), seed=0)


VQ_BUFFERS = ("embed", "cluster_size", "embed_avg", "initted")
VQ_AUX = ("perplexity", "commit_loss")


def _vq_model():
    """A tiny SoundStream (8 windows of 16 x 6 are 32 latent rows for 16
    codes, so k-means leaves codes under the dead-code threshold)."""
    from frankenstein_tpu_torch.models.vq_brain import SoundStream
    from frankenstein_tpu_torch.models.weights import init_soundstream_
    cfg = tconfig.VQVAEConfig(n_electrodes=6, C=8, D=4, codebook_size=16,
                              threshold_ema_dead_code=2.0)
    return init_soundstream_(SoundStream(cfg), seed=0)


def _vq_batch(b: int = 8, t: int = 16):
    """(x [b, t, 6] with one window's last 4 timesteps padding, unused
    targets, dates)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, t, 6)).astype(np.float32)
    x[1, t - 4:] = 0.0
    return (torch.from_numpy(x), torch.zeros(b, 8, dtype=torch.long),
            torch.zeros(b, dtype=torch.long))


def _vq_run(model, tcfg, batch, parallel: bool, steps: int = 3) -> list:
    """Each step's loss, logged aux, parameters and codebook buffers."""
    from frankenstein_tpu_torch.train import trainer
    par = trainer.setup_parallel(model, tcfg, CPU) if parallel else None
    opt, sched = trainer.make_optimizer(tcfg, model)
    state = trainer.TrainState(model, opt, parallel=par)
    gen = torch.Generator(device=CPU)
    book = model.quantizer._codebook
    out = []
    for _ in range(steps):
        loss, aux = trainer.train_step(state, batch, tcfg, sched, gen)
        out.append({"loss": float(loss),
                    **{k: float(aux[k]) for k in VQ_AUX},
                    "params": {n: p.detach().clone()
                               for n, p in model.named_parameters()},
                    "buffers": {n: getattr(book, n).clone()
                                for n in VQ_BUFFERS}})
    return out


def _vq_parity(name: str, **kw) -> dict:
    """Three steps of a fresh SoundStream over the mesh against one rank
    on the same global batch (k-means on step 1, then the EMA and the
    refresh): the worst relative error of each step's loss, logged aux,
    parameters and four codebook buffers over every rank; whether every
    rank holds rank 0's buffers bitwise; whether the reference refreshed a
    dead code (size exactly 1)."""
    tcfg = _train_cfg(**kw)
    batch = _vq_batch()
    model = _vq_model()
    ref = copy.deepcopy(model)
    want = _vq_run(ref, tcfg.replace(mesh_shape=None), batch,
                   parallel=False)
    got = _vq_run(model, tcfg, batch, parallel=True)
    errs = {key: 0.0 for key in ("loss", *VQ_AUX, "params", "buffers")}
    for g, w in zip(got, want):
        for key in ("loss", *VQ_AUX):
            errs[key] = max(errs[key], abs(g[key] - w[key]) / abs(w[key]))
        for key in ("params", "buffers"):
            errs[key] = max([errs[key]] + [_rel(g[key][n], w[key][n])
                                           for n in w[key]])
    worst = torch.tensor([errs[k] for k in sorted(errs)], dtype=torch.float64)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    same = torch.ones(())
    for n in VQ_BUFFERS:
        mine = getattr(model.quantizer._codebook, n)
        first = mine.clone()
        dist.broadcast(first, src=0)
        same *= float(torch.equal(mine, first))
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    refreshed = sum(int((w["buffers"]["cluster_size"] == 1.0).sum())
                    for w in want)
    out = {f"{name}/{k}": float(v) for k, v in zip(sorted(errs), worst)}
    out[f"{name}/same_on_ranks"] = float(same)
    out[f"{name}/refreshed"] = float(refreshed > 0 and all(
        float(w["buffers"]["initted"]) == 1.0 for w in want))
    return out


def check_train_steps(world: int) -> dict:
    """DP (dropout on, 2 microbatches), FSDP, an MoE GPT whose capacity
    drops tokens (its experts over "model" where the mesh has one), the
    MAE (its mask drawn for the global batch), and the VQ-VAE over a data
    group of every rank and of half of them, and with 2 microbatches."""
    from frankenstein_tpu_torch.models.brainformer import MAE
    from frankenstein_tpu_torch.models.weights import init_mae_
    batch = tiny_batch(8)
    out = {}
    out.update(_step_parity("dp", lambda: _franky(dropout=0.1), batch,
                            mesh_shape=(world, 1), grad_accum=2))
    out.update(_step_parity("fsdp", lambda: _franky(), batch,
                            mesh_shape=(world, 1), fsdp=True))
    # capacity factor 0.5: E x cap = 0.5 N k slots for N k choices, so
    # half the choices are dropped
    out.update(_step_parity("moe_dp", lambda: _franky(moe=4, cap=0.5),
                            batch, mesh_shape=(world, 1)))
    if world % 2 == 0:
        out.update(_step_parity("moe_dp_ep",
                                lambda: _franky(moe=4, cap=0.5), batch,
                                mesh_shape=(world // 2, 2)))
    enc = tiny_franky_cfg().brain.encoder
    out.update(_step_parity("mae", lambda: init_mae_(MAE(enc), seed=0),
                            batch, mesh_shape=(world, 1)))
    out.update(_vq_parity(f"vq_dp{world}", mesh_shape=(world, 1)))
    out.update(_vq_parity(f"vq_dp{world // 2}", mesh_shape=(world // 2, 2)))
    out.update(_vq_parity(f"vq_dp{world}_accum2", mesh_shape=(world, 1),
                          grad_accum=2))
    return out


def check_expert_parallel(world: int) -> dict:
    """MoESwiGLU's experts over ``world`` ranks against the whole layer:
    outputs, aux and every gradient; an MoE GPT's loss likewise."""
    from frankenstein_tpu_torch.models.gpt2 import GPT, init_gpt_
    from frankenstein_tpu_torch.models.moe import MoESwiGLU
    torch.manual_seed(4)
    full = MoESwiGLU(8, 16, 4, k=2, capacity_factor=4.0)
    with torch.no_grad():
        for p in full.parameters():
            p.normal_(0, 0.5)
    ep = copy.deepcopy(full)
    group = dist.group.WORLD
    shard_lib.shard_params(ep, group, shard_lib.MOE_EP_RULES)
    x = torch.randn(2, 16, 8, requires_grad=True)
    x2 = x.detach().clone().requires_grad_(True)
    tgt = torch.randn(2, 16, 8)
    y, aux = full(x)
    ((y - tgt).square().mean() + 0.01 * aux).backward()
    y2, aux2 = ep(x2)
    ((y2 - tgt).square().mean() + 0.01 * aux2).backward()
    r, n_loc = dist.get_rank(), 4 // world
    grad_err = max(
        [_err(x2.grad, x.grad), _err(ep.wg.grad, full.wg.grad)]
        + [_err(getattr(ep, w).grad,
                getattr(full, w).grad[r * n_loc:(r + 1) * n_loc])
           for w in ("w1", "w2", "w3")])
    out = {"ep/y": _err(y2, y), "ep/aux": abs(float(aux2) - float(aux)),
           "ep/grads": grad_err,
           "ep/shard_shape": float(tuple(ep.w1.shape) == (n_loc, 8, 16))}
    cfg = tconfig.GPTConfig(block_size=32, vocab_size=96, n_layer=2,
                            n_head=2, n_embd=32, moe_experts=4, moe_k=2)
    gpt = GPT(cfg)
    init_gpt_(gpt, torch.Generator().manual_seed(0))
    idx = torch.from_numpy(np.random.default_rng(3).integers(0, 96, (4, 8)))
    with torch.no_grad():
        ref, _ = gpt(idx, targets=idx)
        shard_lib.shard_params(gpt, group, shard_lib.MOE_EP_RULES)
        got, _ = gpt(idx, targets=idx)
    out["ep/gpt_loss"] = abs(float(got) - float(ref)) / abs(float(ref))
    return out


def _tp_grads(model, batch_fn, mesh) -> tuple:
    """(loss, {name: full gradient}) of ``model`` with its LLaMA split over
    the mesh's "model" dimension and the batch over "data"."""
    data = mesh_lib.group_of(mesh, "data")
    shard_lib.shard_params(model, mesh_lib.group_of(mesh, "model"),
                           shard_lib.LLAMA_TP_RULES)
    with mesh_lib.batch_shard(data):
        loss = batch_fn(model, mesh_lib.shard_batch)
    loss.backward()
    d = mesh_lib.group_size(data)
    specs = {n: getattr(p, "shard_spec", None)
             for n, p in model.named_parameters()}
    grads = {}
    for n, p in model.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g, group=data)
        grads[n] = shard_lib._full(g / d, specs[n])
    loss_t = loss.detach().clone()
    dist.all_reduce(loss_t, group=data)
    return float(loss_t) / d, grads


# the AdamW step after the TP forward and backward: its eps at 1e-3, so
# an element whose gradient is rounding noise (c_attn's key bias, zero in
# exact arithmetic) moves by noise, where eps 1e-8 would move it by
# +-lr on either side
TP_ADAMW = dict(lr=1e-3, eps=1e-3)


def _tp_step(name: str, make, run, mesh, rules, split_data: bool,
             want_split: int) -> dict:
    """One rank's loss, logits, gradients and one AdamW step against the
    same with ``make()``'s model split over the mesh's "model" dimension
    by ``rules`` (and with ``split_data`` the batch over "data", the
    gradients averaged over it): the worst relative error of the loss,
    the logits and the gradients put back together (a tied ``wte``'s
    from both its uses), the largest difference of the stepped
    parameters (as ``_step_parity`` measures them), and whether
    ``want_split`` weights were split. ``run(model, shard)`` -> (loss,
    logits), ``shard`` cutting a tuple of batch tensors to this rank's
    rows."""
    model = make()
    ref = copy.deepcopy(model)
    want, want_logits = run(ref, lambda batch: batch)
    want.backward()
    ref_grads = {n: p.grad.clone() for n, p in ref.named_parameters()}
    torch.optim.AdamW(ref.parameters(), **TP_ADAMW).step()
    data = mesh_lib.group_of(mesh, "data") if split_data else None
    split = shard_lib.shard_params(model, mesh_lib.group_of(mesh, "model"),
                                   rules)
    with mesh_lib.batch_shard(data):
        loss, logits = run(model,
                           lambda batch: mesh_lib.shard_batch(batch, data))
    loss.backward()
    d = mesh_lib.group_size(data)
    specs = {n: getattr(p, "shard_spec", None)
             for n, p in model.named_parameters()}
    for p in model.parameters():
        if d > 1:
            dist.all_reduce(p.grad, group=data)
            p.grad /= d
    grads = {n: shard_lib._full(p.grad, specs[n])
             for n, p in model.named_parameters()}
    torch.optim.AdamW(model.parameters(), **TP_ADAMW).step()
    params = {n: shard_lib._full(p, specs[n])
              for n, p in model.named_parameters()}
    loss_t = loss.detach().clone()
    if d > 1:
        dist.all_reduce(loss_t, group=data)
        parts = [torch.empty_like(logits) for _ in range(d)]
        dist.all_gather(parts, logits.detach().contiguous(), group=data)
        logits = torch.cat(parts)
    return {f"{name}/loss": abs(float(loss_t) / d - float(want))
            / abs(float(want)),
            f"{name}/logits": _rel(logits, want_logits),
            f"{name}/grads": max(_rel(grads[n], g)
                                 for n, g in ref_grads.items()),
            f"{name}/step": max(_err(params[n], p)
                                for n, p in ref.named_parameters()),
            f"{name}/split": float(split == want_split)}


def _refused(calls) -> float:
    """1.0 when every call raises NotImplementedError naming tensor
    parallelism."""
    for call in calls:
        try:
            call()
        except NotImplementedError as e:
            if "tensor-parallel" not in str(e):
                return 0.0
        else:
            return 0.0
    return 1.0


def check_gpt_tensor_parallel(world: int) -> dict:
    """A GPT and a Franky split by ``GPT2_TP_RULES``: TP 2 (each model
    group of 2 ranks on the whole batch) and TP 2 x DP 2, dropout 0 and
    0.1, against one rank; a GPT whose heads and vocabulary do not split
    over 2 and a LLaMA whose KV heads and vocabulary do not (their pairs
    and tables whole, matching one rank); the serving paths of a split GPT
    and LLaMA refused."""
    from frankenstein_tpu_torch.decode import sampling
    from frankenstein_tpu_torch.models.gpt2 import GPT, init_gpt_
    from frankenstein_tpu_torch.models.llama import Llama
    mesh = mesh_lib.make_mesh((world // 2, 2), "cpu")
    rng = np.random.default_rng(6)
    out = {}

    def gpt(**kw):
        cfg = tconfig.GPTConfig(**{**dict(block_size=32, vocab_size=96,
                                          n_layer=2, n_head=4, n_embd=32),
                                   **kw})
        model = GPT(cfg)
        init_gpt_(model, torch.Generator().manual_seed(0))
        with torch.no_grad():      # nonzero biases and norms
            for n, p in model.named_parameters():
                if p.ndim == 1:
                    p.normal_(1.0 if n.endswith("weight") else 0.0, 0.1)
        return model

    def gpt_run(vocab):
        idx = torch.from_numpy(rng.integers(0, vocab, (4, 8)))
        tgt = idx.clone()
        tgt[::2, -3:] = tconfig.IGNORE_INDEX

        def run(m, shard):
            i, t = shard((idx, tgt))
            gen = torch.Generator().manual_seed(3)
            return m(i, targets=t, train=True, generator=gen)
        return run

    rules = shard_lib.GPT2_TP_RULES
    for rate in (0.0, 0.1):
        tag = "_dropout" if rate else ""
        run = gpt_run(96)
        # per layer c_attn, attn c_proj, c_fc, mlp c_proj; and wte
        out.update(_tp_step(f"gpt_tp/tp2{tag}", lambda: gpt(dropout=rate),
                            run, mesh, rules, split_data=False,
                            want_split=9))
        out.update(_tp_step(f"gpt_tp/tp2_dp2{tag}",
                            lambda: gpt(dropout=rate), run, mesh, rules,
                            split_data=True, want_split=9))
    x, y, _ = tiny_batch(4, seed=8)

    def franky_run(m, shard):
        xs, ys = shard((x, y))
        gen = torch.Generator().manual_seed(4)
        return m(xs, ys, train=True, generator=gen)

    def franky(**kw):
        model = _franky(**kw)
        with torch.no_grad():      # zero queries make the Perceiver's
            model.brain_model.learnable_queries.normal_(   # q/k grads noise
                generator=torch.Generator().manual_seed(5))
        return model

    out.update(_tp_step("gpt_tp/franky_tp2", franky, franky_run, mesh,
                        rules, split_data=False, want_split=9))
    out.update(_tp_step("gpt_tp/franky_tp2_dp2_dropout",
                        lambda: franky(dropout=0.1), franky_run, mesh,
                        rules, split_data=True, want_split=9))
    # 3 heads and 97 tokens do not split over 2: c_attn / c_proj and wte
    # stay whole, c_fc / mlp c_proj split (4 weights)
    out.update(_tp_step("gpt_tp/indivisible",
                        lambda: gpt(n_head=3, n_embd=24, vocab_size=97),
                        gpt_run(97), mesh, rules, split_data=True,
                        want_split=4))

    def llama():
        torch.manual_seed(2)
        lm = Llama(tconfig.tiny_llama_config(n_kv_heads=1, vocab_size=129))
        with torch.no_grad():
            for p in lm.parameters():
                p.normal_(0, 0.1)
        return lm

    idx = torch.from_numpy(rng.integers(0, 129, (4, 8)))

    def llama_run(m, shard):
        i, t = shard((idx, idx))
        return m(i, targets=t)

    # one KV head and 129 tokens: q/k/v/o and both tables whole, the
    # SwiGLU split (3 weights a layer)
    out.update(_tp_step("llama_tp/indivisible", llama, llama_run, mesh,
                        shard_lib.LLAMA_TP_RULES, split_data=True,
                        want_split=6))

    split = gpt()
    shard_lib.shard_params(split, mesh_lib.group_of(mesh, "model"), rules)
    cache = split.init_decode_cache(1, 16)
    ids = torch.zeros(1, 1, dtype=torch.long)
    out["gpt_tp/serving_refused"] = _refused([
        lambda: split.prefill(ids, None, cache),
        lambda: split.decode_step(ids[:, 0], cache, 1),
        lambda: split.decode_step_topk(ids[:, 0], cache, 1, k=2),
        lambda: sampling.decode_weights(split, int8_weights=False),
        lambda: sampling.generate(split, ids, None, max_new_tokens=2,
                                  greedy=True)])
    lm = llama()
    shard_lib.shard_params(lm, mesh_lib.group_of(mesh, "model"))
    lm_cache = lm.init_decode_cache(1, 16)
    out["llama_tp/serving_refused"] = _refused([
        lambda: lm.prefill(ids, None, lm_cache),
        lambda: lm.decode_step(ids[:, 0], lm_cache, 1),
        lambda: sampling.decode_weights(lm, int8_weights=False)])
    return out


def check_tensor_parallel(world: int) -> dict:
    """LLaMA and FrankyLlama with TP over "model" x DP over "data":
    the loss and every gradient against one rank."""
    from frankenstein_tpu_torch.models.franky import FrankyLlama
    from frankenstein_tpu_torch.models.llama import Llama
    from frankenstein_tpu_torch.models.weights import init_franky_llama_
    mesh = mesh_lib.make_mesh((world // 2, 2), "cpu")
    out = {}
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 128, (4, 8)))
    tgt = idx.clone()
    tgt[::2, -3:] = tconfig.IGNORE_INDEX

    def llama_loss(m, shard):
        i, t = shard((idx, tgt), mesh_lib.group_of(mesh, "data"))
        return m(i, targets=t)[0]

    torch.manual_seed(1)
    lm = Llama(tconfig.tiny_llama_config())
    with torch.no_grad():
        for p in lm.parameters():
            p.normal_(0, 0.1)
    ref = copy.deepcopy(lm)
    want = ref(idx, targets=tgt)[0]
    want.backward()
    got, grads = _tp_grads(lm, llama_loss, mesh)
    out["tp/llama_loss"] = abs(got - float(want)) / abs(float(want))
    out["tp/llama_grads"] = max(_rel(grads[n], p.grad)
                                for n, p in ref.named_parameters())
    out["tp/llama_sharded"] = float(lm.model.layers[0].self_attn.q_proj
                                    .weight.shape[0] == 16)

    lm7 = tconfig.tiny_llama_config(vocab_size=512)
    cfg7 = tconfig.FrankyLlamaConfig(
        brain=tiny_franky_cfg().brain.replace(output_dim=lm7.dim),
        lm=lm7, max_tokens=8, pad_token_id=511)
    fl = init_franky_llama_(FrankyLlama(cfg7), seed=0)
    with torch.no_grad():      # zero queries make the Perceiver's
        fl.brain_model.learnable_queries.normal_()   # q/k grads noise
    x, y, _ = tiny_batch(4, seed=7)
    ref = copy.deepcopy(fl)
    want = ref(x, y)[0]
    want.backward()

    def fl_loss(m, shard):
        xs, ys = shard((x, y), mesh_lib.group_of(mesh, "data"))
        return m(xs, ys)[0]

    got, grads = _tp_grads(fl, fl_loss, mesh)
    out["tp/franky_llama_loss"] = abs(got - float(want)) / abs(float(want))
    out["tp/franky_llama_grads"] = max(_rel(grads[n], p.grad)
                                       for n, p in ref.named_parameters())

    return out


def _pp_layer(lp, h):
    return h + torch.tanh(h @ lp["w1"]) @ lp["w2"]


def check_pipeline(world: int) -> dict:
    """GPipe over ``world`` stages and DP x PP against the sequential
    stack: outputs and gradients; bad microbatching is refused."""
    g = torch.Generator().manual_seed(0)
    n_layers, e, f = 2 * world, 16, 32
    stacked = {"w1": torch.randn(n_layers, e, f, generator=g) * 0.2,
               "w2": torch.randn(n_layers, f, e, generator=g) * 0.2}
    x = torch.randn(8, e, generator=g)
    tgt = torch.randn(8, e, generator=g)
    seq = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    want = pp.stage_scan(_pp_layer)(seq, x)
    ((want - tgt) ** 2).mean().backward()
    out = {}
    group = dist.group.WORLD
    local = pp.stage_params(stacked, group)
    got = pp.pipelined_apply(pp.stage_scan(_pp_layer), local, x, 4, group)
    ((got - tgt) ** 2).mean().backward()
    s, per = dist.get_rank(), n_layers // world
    out["pp/out"] = _err(got, want)
    out["pp/grads"] = max(_err(local[k].grad, seq[k].grad[s * per:
                                                          (s + 1) * per])
                          for k in local)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", pp.STAGE_AXIS))
    stage, data = mesh[pp.STAGE_AXIS].get_group(), mesh["data"].get_group()
    local = pp.stage_params(stacked, stage)
    got = pp.pipelined_apply(pp.stage_scan(_pp_layer), local, x, 2, stage,
                             data_group=data)
    ((got - tgt) ** 2).mean().backward()
    mesh_lib.sum_grads(local.values(), data)
    s, per = mesh_lib.group_rank(stage), n_layers // (world // 2)
    out["dp_pp/out"] = _err(got, want)
    out["dp_pp/grads"] = max(_err(local[k].grad, seq[k].grad[s * per:
                                                             (s + 1) * per])
                             for k in local)
    refused = 0
    for call in (lambda: pp.gpipe(pp.stage_scan(_pp_layer), group, 0),
                 lambda: pp.pipelined_apply(pp.stage_scan(_pp_layer),
                                            local, x, 3, stage,
                                            data_group=data)):
        try:
            call()
        except ValueError:
            refused += 1
    out["pp/refused"] = float(refused == 2)
    return out


def _dense(q, k, v, causal, slab):
    t, d = q.shape[1], q.shape[-1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    pos = torch.arange(t)
    mask = ra._block_mask(pos, pos, causal, slab)
    if mask is not None:
        sc = sc.masked_fill(~mask, ra.NEG_INF)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)


def check_ring(world: int, refs: dict) -> dict:
    """Ring attention (full, causal, slab) against dense attention and
    the JAX package's ``ring_attention_sharded``; gradients against the
    dense ones; the seq_parallel encoder against the one-device encoder;
    an indivisible sequence refused."""
    from frankenstein_tpu_torch.models.brainformer import MAE
    from frankenstein_tpu_torch.models.weights import init_mae_
    group = dist.group.WORLD
    qkv = [torch.from_numpy(refs[f"ring_{n}"]) for n in "qkv"]
    w = torch.from_numpy(refs["ring_w"])
    out = {}
    for mode, causal, slab in (("full", False, None), ("causal", True, None),
                               ("slab", False, 4)):
        a = [t.clone().requires_grad_(True) for t in qkv]
        b = [t.clone().requires_grad_(True) for t in qkv]
        got = ra.ring_attention_sharded(*a, group, causal=causal, slab=slab)
        want = _dense(*b, causal, slab)
        (got * w).sum().backward()
        (want * w).sum().backward()
        out[f"ring/{mode}/dense"] = _err(got, want)
        out[f"ring/{mode}/jax"] = _err(got, refs[f"ring_out_{mode}"])
        out[f"ring/{mode}/grads"] = max(_err(x.grad, y.grad)
                                        for x, y in zip(a, b))
    try:
        ra.ring_attention_sharded(qkv[0][:, :-1], qkv[1][:, :-1],
                                  qkv[2][:, :-1], group)
        out["ring/refused"] = 0.0
    except ValueError:
        out["ring/refused"] = 1.0
    enc_cfg = tiny_franky_cfg().brain.encoder.replace(seq_parallel=True)
    mae = init_mae_(MAE(enc_cfg), seed=0)
    ref = copy.deepcopy(mae.encoder)
    x = torch.from_numpy(refs["enc_x"])
    want = ref(x)
    (want * want).sum().backward()
    with ra.seq_group(group):
        got = mae.encoder(x)
    (got * got).sum().backward()
    enc = mae.encoder
    mesh_lib.sum_grads([p for m in (enc.transformer["h"],
                                    enc.transformer["ln_f"])
                        for p in m.parameters()], group)
    out["seq_parallel/out"] = _err(got, want)
    out["seq_parallel/grads"] = max(
        _err(p.grad, q.grad) for p, q in zip(enc.parameters(),
                                             ref.parameters()))
    return out


def check_serving(world: int) -> dict:
    """Greedy, beam and int8-KV decode with the batch split over the
    ranks against one rank, and the strings of ``make_predictions``."""
    from frankenstein_tpu_torch.decode import sampling
    from frankenstein_tpu_torch.decode.pipeline import make_franky_predictor
    from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
    from frankenstein_tpu_torch.eval.submission import make_predictions
    group = dist.group.WORLD
    model = _franky()
    lm = model.llm_model
    rng = np.random.default_rng(0)
    b = 2 * world
    idx0 = torch.from_numpy(rng.integers(0, 299, (b, 4)))
    prefix = torch.from_numpy(rng.normal(size=(b, 3, 24)).astype(np.float32))
    mine = lambda t: mesh_lib.shard_batch((t,), group)[0]
    out = {}
    for name, fn in (
            ("greedy", lambda i, p: sampling.generate(
                lm, i, p, max_new_tokens=5, greedy=True)),
            ("beam", lambda i, p: sampling.beam_search(
                lm, i, p, max_new_tokens=4, beam_width=3)[0]),
            ("int8_kv", lambda i, p: sampling.generate(
                lm, i, p, max_new_tokens=5, greedy=True, int8_kv=True))):
        want = fn(idx0, prefix)
        with mesh_lib.batch_shard(group):
            got = fn(mine(idx0), mine(prefix))
        out[f"serve/{name}"] = float(torch.equal(got, mine(want)))
    tok = ByteTokenizer(eot_id=299)
    predict = make_franky_predictor(model, tok, max_new_tokens=4,
                                    beam_width=2, eot_id=299)
    ds = [(rng.standard_normal((32, 8)).astype(np.float32),)
          for _ in range(2 * world + 1)]
    want = make_predictions(ds, predict, batch_size=2 * world + 1)
    got = make_predictions(ds, predict, batch_size=2 * world + 1,
                           group=group)
    out["serve/strings"] = float(got == want)
    return out


SUITES = {
    "train": [check_train_steps],
    "experts": [check_expert_parallel],
    "layouts": [check_tensor_parallel, check_gpt_tensor_parallel,
                check_pipeline, check_ring, check_serving],
}


def main(argv) -> None:
    suite, rank, world, init_file, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    refs_path = Path(out + ".refs.npz")
    refs = dict(np.load(refs_path)) if refs_path.exists() else {}
    results = {}
    for check in SUITES[suite]:
        torch.manual_seed(0)
        if check is check_ring:
            results.update(check(world, refs))
        else:
            results.update(check(world))
    if rank == 0:
        Path(out).write_text(json.dumps(results))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])


def spawn(suite: str, world: int, tmp: Path, refs: dict = None,
          timeout: float = 240.0) -> dict:
    """Run ``suite`` on ``world`` gloo ranks (one process each, joined
    through a file in ``tmp``, so test files running side by side share no
    port) and return rank 0's results. A rank that fails, or a run that
    outlasts ``timeout`` seconds (a hung collective), raises with every
    rank's log."""
    import os
    import subprocess
    import time
    tmp = Path(tmp)
    out = tmp / f"{suite}_{world}.json"
    if refs:
        np.savez(str(out) + ".refs.npz", **refs)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(root))
    logs = [tmp / f"{suite}_{world}_rank{r}.log" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_workers", suite,
         str(r), str(world), str(tmp / f"{suite}_{world}.init"), str(out)],
        cwd=root, env=env, stdout=open(logs[r], "w"),
        stderr=subprocess.STDOUT) for r in range(world)]
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
    if any(p.returncode != 0 for p in procs) or not out.exists():
        text = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n"
                         + logs[r].read_text()[-4000:]
                         for r, p in enumerate(procs))
        raise RuntimeError(f"{suite} on {world} ranks failed:\n{text}")
    return json.loads(out.read_text())
