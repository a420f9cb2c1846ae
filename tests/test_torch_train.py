"""The port's training slice against the JAX package on the CPU, at a tiny
Franky: gradients (every parameter, the tied ``wte`` included) against
``jax.grad``, the optimizer against optax on the same gradients, the
schedule against the reference formula, and the trainer's accumulation,
grouped steps, augmentation, checkpoints, resume and NaN stop. float32."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.models.franky import Franky as JFranky
from frankenstein_tpu.models.import_reference import export_franky
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.data import datasets, tokenizers
from frankenstein_tpu_torch.models.brainformer import MAE
from frankenstein_tpu_torch.models.franky import Franky
from frankenstein_tpu_torch.models.weights import (init_franky_, init_mae_,
                                                   load_strict)
from frankenstein_tpu_torch.train import checkpoints as ckpt_lib
from frankenstein_tpu_torch.train import trainer
from frankenstein_tpu_torch.train.__main__ import main as train_main
from frankenstein_tpu_torch.train.schedule import make_lr_schedule
from tests.test_trainer import reference_get_lr

torch.set_num_threads(1)


def tiny_cfg(mod, n_gpt_layers=2, dropout=0.0):
    """Encoder 1 layer, dim 16, T=32 tokens; GPT n_embd 24, vocab 300."""
    return mod.FrankyConfig(
        brain=mod.PerceiverConfig(
            encoder=mod.MAEConfig(window_size=32, n_electrodes=8,
                                  patch_size=8, dim=16, n_layers=1,
                                  head_dim=8, hidden_dim=32, n_heads=2,
                                  n_kv_heads=2, n_dec_layers=1,
                                  decoder_dim=16),
            n_output_tokens=4, output_dim=24, dim=16, n_layers=1, head_dim=8,
            hidden_dim=32, n_heads=2, n_kv_heads=2),
        gpt=mod.GPTConfig(block_size=32, vocab_size=300,
                          n_layer=n_gpt_layers, n_head=2, n_embd=24,
                          dropout=dropout),
        max_tokens=8, pad_token_id=299)


def tiny_batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 32, 8)).astype(np.float32)
    y = rng.integers(0, 256, (n, 8)).astype(np.int64)
    y[:, -2:] = -100
    return x, y


def tiny_model(seed=0, **kw):
    return init_franky_(Franky(tiny_cfg(tconfig, **kw)), seed=seed)


def tiny_data(n=16, seed=0, nan=False):
    tok = tokenizers.get_tokenizer(tokenizers.ByteTokenizer(eot_id=299))
    ds = datasets.BrainDataset.synthetic(n, seed=seed, tokenize_function=tok,
                                         n_electrodes=8, max_input_len=32,
                                         max_tokens=8)
    if nan:
        ds.inputs = [np.full_like(a, np.nan) for a in ds.inputs]
    return ds


def train_cfg(**kw):
    base = dict(exp_name="t", batch_size=4, max_steps=3, eval_interval=100,
                log_interval=1, warmup_iters=0, use_scheduler=False,
                mixed_precision=False)
    return tconfig.TrainConfig(**{**base, **kw})


def test_every_gradient_matches_jax_tied_wte_included():
    """One f32 loss and backward on both sides, random learnable queries
    (zero queries make the Perceiver's self-attention kw gradient noise):
    every gradient within 1e-5 of its own max |value|. The tied wte gets
    the head's share too."""
    rng = np.random.default_rng(0)
    x, y = tiny_batch()
    jmodel = JFranky(tiny_cfg(jconfig))
    params = jmodel.init(jax.random.key(0), jnp.asarray(x[:1]),
                         jnp.asarray(y[:1]))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)

    def loss_fn(p):
        return jmodel.apply(p, jnp.asarray(x), jnp.asarray(y))[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = export_franky(jgrads)
    model = load_strict(Franky(tiny_cfg(tconfig)), export_franky(params))
    loss, _ = model(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    names = [n for n, _ in model.named_parameters()]
    assert "llm_model.transformer.wte.weight" in names
    for name, p in model.named_parameters():
        w = np.asarray(want[name])
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("mask", [False, True])
def test_optimizer_matches_optax_on_the_same_gradients(mask):
    """3 updates from the same gradients (some past the clip): the port's
    make_optimizer + apply_update against optax clip + adamw with the
    schedule (warmup, so the first update has lr 0), weight decay and the
    ndim >= 2 mask. Within 1e-7, plus 2e-7 of the value: torch and optax
    order the same f32 operations differently (decay before or after the
    Adam term), which moves a parameter of magnitude 3 by up to two ulps."""
    cfg = tconfig.TrainConfig(learning_rate=1e-2, weight_decay=0.1,
                              weight_decay_mask=mask, warmup_iters=2,
                              lr_decay_iters=10, grad_clip=1.0)
    model = tiny_model()
    named = dict(model.named_parameters())
    # jnp.array copies: jnp.asarray would alias the torch parameters, which
    # the torch steps then update in place under JAX's async updates
    params = {n: jnp.array(p.detach().numpy()) for n, p in named.items()}
    jcfg = jconfig.TrainConfig(**dataclasses.asdict(cfg))
    from frankenstein_tpu.train.trainer import make_optimizer as jmake
    tx, _ = jmake(jcfg)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    opt, sched = trainer.make_optimizer(cfg, model)
    state = trainer.TrainState(model, opt)
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = {n: (rng.standard_normal(p.shape) * 1.5).astype(np.float32)
                 for n, p in named.items()}
        for n, p in named.items():
            p.grad = torch.from_numpy(grads[n].copy())
        trainer.apply_update(state, cfg, sched)
        updates, opt_state = update(
            {n: jnp.asarray(g) for n, g in grads.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
    assert state.step == 3
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]),
                                   atol=1e-7, rtol=2e-7, err_msg=n)


def test_weight_decay_mask_spares_biases_and_norms():
    model = tiny_model()
    opt, _ = trainer.make_optimizer(tconfig.TrainConfig(
        weight_decay_mask=True), model)
    decay, spare = opt.param_groups
    assert spare["weight_decay"] == 0.0 and decay["weight_decay"] == 1e-5
    ids = lambda g: {id(p) for p in g["params"]}
    names = {id(p): n for n, p in model.named_parameters()}
    assert len(ids(decay) | ids(spare)) == len(names)   # tied wte once
    for pid in ids(spare):
        assert names[pid].endswith("bias") or ".ln_" in names[pid], \
            names[pid]
    assert id(model.llm_model.transformer["wte"].weight) in ids(decay)
    plain, _ = trainer.make_optimizer(tconfig.TrainConfig(), model)
    assert len(plain.param_groups) == 1


def test_schedule_matches_reference():
    cfg = tconfig.TrainConfig(learning_rate=1e-3, warmup_iters=10,
                              lr_decay_iters=100)
    sched = make_lr_schedule(cfg)
    for it in [0, 1, 5, 10, 11, 50, 99, 100, 101, 500]:
        np.testing.assert_allclose(sched(it),
                                   reference_get_lr(it, 1e-3, 10, 100),
                                   rtol=1e-12)
    assert make_lr_schedule(cfg.replace(use_scheduler=False))(7) == 1e-3


def _grads(model, batch, cfg):
    state = trainer.TrainState(model, trainer.make_optimizer(cfg, model)[0])
    loss = trainer.loss_and_grads(state, batch, cfg)
    return float(loss), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


def test_grad_accum_matches_one_batch():
    batch = tuple(torch.from_numpy(a) for a in tiny_batch(4))
    cfg = train_cfg()
    l1, g1 = _grads(tiny_model(), batch, cfg)
    l2, g2 = _grads(tiny_model(), batch, cfg.replace(grad_accum=2))
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for n in g1:
        np.testing.assert_allclose(g2[n].numpy(), g1[n].numpy(),
                                   atol=1e-6 * float(g1[n].abs().max()),
                                   err_msg=n)


def test_steps_per_dispatch_equals_single_steps(tmp_path):
    """k=3 runs the same three updates as three single steps; a group never
    stops inside itself, so max_steps=4 ends at step 6."""
    data = (tiny_data(), tiny_data(8, seed=1))
    one = trainer.run_train_model(tiny_model(), data, train_cfg(),
                                  save_folder=tmp_path / "a")
    three = trainer.run_train_model(
        tiny_model(), data, train_cfg(steps_per_dispatch=3),
        save_folder=tmp_path / "b")
    assert one.step == three.step == 3
    for (n, a), b in zip(one.model.named_parameters(),
                         three.model.parameters()):
        assert torch.equal(a, b), n
    over = trainer.run_train_model(
        tiny_model(), data, train_cfg(steps_per_dispatch=3, max_steps=4),
        save_folder=tmp_path / "c")
    assert over.step == 6
    log = tmp_path / "c" / "t" / "metrics.jsonl"
    logged = [json.loads(line)["step"] for line in
              log.read_text().splitlines()]
    assert logged == [3, 6]


@pytest.mark.parametrize("p_augs", [0.0, 1.0])
def test_augment_batch_zeroes_one_span(p_augs):
    x = torch.ones(64, 48, 3)
    gen = torch.Generator().manual_seed(0)
    out, y = trainer.augment_batch((x, "labels"), gen, p_augs)
    assert y == "labels"
    zeroed = (out == 0).all(dim=-1)                     # [B, T]
    span = 48 // 16
    assert (zeroed.sum(dim=1) == (span if p_augs else 0)).all()
    if p_augs:   # one contiguous span per sample
        first = zeroed.int().argmax(dim=1)
        for b in range(64):
            assert zeroed[b, first[b]:first[b] + span].all()


def test_augment_batch_applies_with_its_probability():
    x = torch.ones(4000, 32, 1)
    out, = trainer.augment_batch((x,), torch.Generator().manual_seed(1), 0.3)
    applied = float((out == 0).any(dim=1).float().mean())
    assert abs(applied - 0.3) < 0.03


def test_dropout_is_seeded_and_remat_recomputes_it():
    """GPT dropout in training draws from the generator: the same seed gives
    the same loss, eval ignores it; with remat the gradients are those of
    the plain run (the recomputed blocks draw the same masks)."""
    batch = [torch.from_numpy(a) for a in tiny_batch(4)]
    model = tiny_model(dropout=0.3)
    run = lambda seed: model(*batch, train=True,
                             generator=torch.Generator().manual_seed(seed))[0]
    assert run(0).item() == run(0).item() != run(1).item()
    assert model(*batch)[0].item() != run(0).item()
    grads = []
    for remat in (False, True):
        model.zero_grad()
        model.remat = remat
        run(0).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_checkpoints_keep_the_best_and_restore(tmp_path):
    cfg = train_cfg()
    model = tiny_model()
    state = trainer.TrainState(model, trainer.make_optimizer(cfg, model)[0])
    batch = tuple(torch.from_numpy(a) for a in tiny_batch(4))
    sched = make_lr_schedule(cfg)
    for step, loss in enumerate([3.0, 1.0, 2.0, 0.5]):
        trainer.train_step(state, batch, cfg, sched, torch.Generator())
        ckpt_lib.save_checkpoint(tmp_path, state, state.step, loss, keep=2)
    kept = sorted(d.name for d in tmp_path.glob("step_*"))
    assert kept == ["step_2_loss_1.0000", "step_4_loss_0.5000"]
    best = ckpt_lib.best_checkpoint(tmp_path)
    assert best.name == "step_4_loss_0.5000"
    fresh = tiny_model(seed=5)
    restored = ckpt_lib.restore_checkpoint(best, trainer.TrainState(
        fresh, trainer.make_optimizer(cfg, fresh)[0]))
    assert restored.step == 4
    for a, b in zip(state.model.state_dict().values(),
                    fresh.state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    for i, st in sa["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(st[key], sb["state"][i][key])
    raw = ckpt_lib.load_raw_checkpoint(tmp_path)      # a run dir: the best
    assert raw["step"] == 4


def test_resume_continues_from_the_best_checkpoint(tmp_path):
    data = (tiny_data(), tiny_data(8, seed=1))
    first = trainer.run_train_model(tiny_model(), data,
                                    train_cfg(max_steps=2, eval_interval=2),
                                    save_folder=tmp_path)
    assert ckpt_lib.best_checkpoint(tmp_path / "t").name.startswith("step_2")
    again = trainer.run_train_model(tiny_model(seed=9), data,
                                    train_cfg(max_steps=4, eval_interval=2),
                                    save_folder=tmp_path, resume=True)
    assert again.step == 4
    adam = again.optimizer.state_dict()["state"][0]["step"]
    assert float(adam) == 4.0
    assert first.step == 2


def test_eval_metric_selects_the_checkpoint(tmp_path):
    data = (tiny_data(), tiny_data(8, seed=1))
    scores = iter([5.0, 7.0])
    trainer.run_train_model(tiny_model(), data,
                            train_cfg(max_steps=4, eval_interval=2),
                            save_folder=tmp_path,
                            eval_metric=lambda state, step: next(scores))
    assert [d.name for d in (tmp_path / "t").glob("step_*")] == [
        "step_2_loss_5.0000"]


def test_non_finite_loss_raises(tmp_path):
    data = (tiny_data(nan=True), tiny_data(8, seed=1))
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.run_train_model(tiny_model(), data, train_cfg(),
                                save_folder=tmp_path)
    last = (tmp_path / "t" / "metrics.jsonl").read_text().splitlines()[-1]
    assert json.loads(last)["fatal"] == 1.0


def tiny_mae(seed=0, **geometry):
    """An MAE over tiny_cfg's encoder geometry (32 tokens)."""
    enc = tiny_cfg(tconfig).brain.encoder.replace(**geometry)
    return init_mae_(MAE(enc), seed=seed)


def _train_mae(tmp_path, exp_name="mae", **geometry):
    data = (tiny_data(), tiny_data(8, seed=1))
    return trainer.run_train_model(
        tiny_mae(**geometry), data,
        train_cfg(exp_name=exp_name, max_steps=2, eval_interval=2),
        save_folder=tmp_path)


def test_mae_trains_and_evaluates_with_a_seeded_mask(tmp_path):
    state = _train_mae(tmp_path)
    assert state.step == 2
    records = [json.loads(line) for line in
               (tmp_path / "mae" / "metrics.jsonl").read_text().splitlines()]
    val = [r["val/loss"] for r in records if "val/loss" in r]
    assert len(val) == 1 and np.isfinite(val[0])
    again = _train_mae(tmp_path / "again")
    records = (tmp_path / "again" / "mae" / "metrics.jsonl").read_text()
    assert [json.loads(r)["val/loss"] for r in records.splitlines()
            if "val/loss" in r] == val
    x, y = tiny_batch()
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    loss = lambda seed: float(trainer.eval_step(
        state, batch, torch.Generator().manual_seed(seed)))
    assert loss(3) == loss(3) and loss(3) != loss(4)


def test_graft_copies_the_mae_encoder_bitwise(tmp_path):
    mae = _train_mae(tmp_path).model
    model = tiny_model(seed=7)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ckpt_lib.graft_encoder_from_mae(tmp_path / "mae", model)   # a run dir
    want = mae.encoder.state_dict()
    for name, value in model.state_dict().items():
        if name.startswith("brain_model.encoder."):
            assert torch.equal(value, want[name[len("brain_model.encoder."):]])
        else:
            assert torch.equal(value, before[name]), name


def test_graft_takes_a_composite_checkpoint(tmp_path):
    src = trainer.run_train_model(
        tiny_model(seed=3), (tiny_data(), tiny_data(8, seed=1)),
        train_cfg(max_steps=2, eval_interval=2), save_folder=tmp_path).model
    model = ckpt_lib.graft_encoder_from_mae(tmp_path / "t",
                                            tiny_model(seed=8))
    for name, value in src.brain_model.encoder.state_dict().items():
        assert torch.equal(model.brain_model.encoder.state_dict()[name],
                           value)


@pytest.mark.parametrize("geometry,match", [({"dim": 24, "decoder_dim": 24},
                                             "geometry mismatch"),
                                            ({"n_layers": 2}, "differ")])
def test_graft_refuses_another_geometry(tmp_path, geometry, match):
    _train_mae(tmp_path, **geometry)
    with pytest.raises(ValueError, match=match):
        ckpt_lib.graft_encoder_from_mae(tmp_path / "mae", tiny_model())


def test_cli_grafts_only_into_franky():
    with pytest.raises(SystemExit, match="--model franky, moe-gpt or "
                       "franky-llama, not mae"):
        train_main(["--model", "mae", "--data", "synthetic",
                    "--init-encoder-from", "logs/none"])


def test_loader_stacks_steps_and_stops_its_thread():
    import threading

    from frankenstein_tpu_torch.data import loader
    batches = [(np.full((2, 3), i), np.arange(2) + i) for i in range(7)]
    groups = list(loader.stack_steps(iter(batches), 3))
    assert len(groups) == 2 and groups[1][0].shape == (3, 2, 3)
    assert groups[1][1][:, 0].tolist() == [3, 4, 5]      # partial dropped
    moved = list(loader.to_device(iter(groups), "cpu"))
    assert moved[0][0].dtype == torch.int64 and moved[0][0].shape == (3, 2, 3)

    def endless():
        while True:
            yield (np.zeros(1),)

    before = threading.active_count()
    it = loader.prefetch(endless())
    next(it)
    it.close()
    assert threading.active_count() == before

    def broken():
        yield (np.zeros(1),)
        raise ValueError("bad batch")

    with pytest.raises(ValueError, match="bad batch"):
        list(loader.prefetch(broken()))
