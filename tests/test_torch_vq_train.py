"""Training the port's VQ-VAE on the CPU: ``--model vqvae`` by flags and by
a tiny YAML (the aux keys logged, ``mfu`` absent without a card), grad
accumulation threading the codebook from microbatch to microbatch as the
JAX package's scan threads its ``"vq"`` collection, ``remat`` recomputing
the convs but not the quantizer, checkpoints and resume carrying the
codebook buffers, and the CLI's GPU default. float32; inputs from numpy
seeds."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.models import vq_brain as jvq_brain
from frankenstein_tpu.models.import_reference import export_soundstream
from frankenstein_tpu.train import trainer as jtrainer
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.models.vq_brain import SoundStream
from frankenstein_tpu_torch.models.weights import (init_soundstream_,
                                                   load_strict)
from frankenstein_tpu_torch.train import checkpoints as ckpt_lib
from frankenstein_tpu_torch.train import trainer
from frankenstein_tpu_torch.train.__main__ import main as train_main
from frankenstein_tpu_torch.train.schedule import make_lr_schedule

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5     # f32 on both sides
GEOM = dict(n_electrodes=6, C=8, D=4, codebook_size=16,
            threshold_ema_dead_code=0.0)
AUX = ("perplexity", "rec_loss", "commit_loss")

TINY_VQ_YAML = """\
model: vqvae
model_config:
  n_electrodes: 8
  C: 8
  D: 4
  codebook_size: 16
  strides: [2, 2]
train:
  exp_name: vq
  batch_size: 4
  max_steps: 3
  eval_interval: 3
  log_interval: 1
  warmup_iters: 1
  mixed_precision: false
"""


def _train_cfg(**kw):
    base = dict(exp_name="vq", batch_size=4, max_steps=2, eval_interval=2,
                log_interval=1, warmup_iters=0, use_scheduler=False,
                mixed_precision=False)
    return tconfig.TrainConfig(**{**base, **kw})


def _batch(seed=0, n=4, t=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t, GEOM["n_electrodes"])).astype(np.float32)
    x[1, t - 4:] = 0.0
    return x, np.zeros((n, 8), np.int64), np.zeros((n,), np.int32)


def _jax_pair(seed=0):
    """(jax spec, its TrainState from perturbed initted variables, the port
    model with the same weights)."""
    cfg = jconfig.VQVAEConfig(**GEOM)
    spec = jtrainer.TrainableSpec(
        module=jvq_brain.SoundStream(cfg), rng_names=("vq",),
        mutable=("vq",), needs_train_flag=True, needs_labels=False)
    x, y, d = _batch(seed)
    state, tx = jtrainer.init_state(spec, _train_cfg(), (x, y, d))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        state.params)
    q = state.extra["vq"]["quantizer"]
    extra = {"vq": {"quantizer": {
        "codebook": jnp.asarray(rng.standard_normal(
            q["codebook"].shape).astype(np.float32)),
        "cluster_size": q["cluster_size"] + 1.0,
        "initted": jnp.ones((), jnp.bool_)}}}
    state = state.replace(params=params, extra=extra,
                          opt_state=tx.init(params))
    model = load_strict(SoundStream(tconfig.VQVAEConfig(**GEOM)),
                        export_soundstream({"params": params, **extra}))
    return spec, state, tx, model


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_threads_the_codebook_as_jax(accum):
    """With grad_accum 2 the second microbatch quantizes against the
    codebook the first one wrote (the JAX scan's ``extra``): the loss, the
    gradient norm, the mean aux and the codebook after the step are the
    JAX package's."""
    spec, jstate, tx, model = _jax_pair()
    cfg = _train_cfg(grad_accum=accum)
    batch = _batch()
    jstep = jtrainer.make_train_step(spec, tx, cfg)
    new_state, jloss, jaux = jstep(jstate, tuple(map(jnp.asarray, batch)),
                                   jax.random.key(0))
    state = trainer.TrainState(model, trainer.make_optimizer(cfg, model)[0])
    loss, aux = trainer.train_step(
        state, tuple(map(torch.from_numpy, batch)), cfg,
        make_lr_schedule(cfg), torch.Generator())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    np.testing.assert_allclose(float(aux["grad_norm"]),
                               float(jaux["grad_norm"]), rtol=1e-4)
    for key in AUX:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=TOL, err_msg=key)
    q = new_state.extra["vq"]["quantizer"]
    book = model.quantizer._codebook
    np.testing.assert_allclose(book.embed.numpy(), np.asarray(q["codebook"]),
                               atol=1e-6)
    np.testing.assert_allclose(book.cluster_size.numpy(),
                               np.asarray(q["cluster_size"]), atol=1e-6)


def _yaml_lr_cfg(steps):
    """configs/vqvae.yaml's optimizer and schedule at a warm-up of 5 steps,
    so the lr reaches the YAML's 1e-3 inside a short run."""
    return _train_cfg(max_steps=steps, learning_rate=1e-3, weight_decay=1e-5,
                      warmup_iters=5, lr_decay_iters=50_000,
                      use_scheduler=True)


def test_thirty_steps_at_the_yaml_lr_track_jax():
    """30 optimizer steps at lr 1e-3 with no draws (initted, threshold 0):
    each step's loss and the codebook after the last are the JAX
    package's."""
    spec, jstate, _, model = _jax_pair()
    cfg = _yaml_lr_cfg(30)
    tx, _ = jtrainer.make_optimizer(cfg)    # the schedule lives in the tx
    jstate = jstate.replace(opt_state=tx.init(jstate.params))
    jstep = jtrainer.make_train_step(spec, tx, cfg)
    state = trainer.TrainState(model, trainer.make_optimizer(cfg, model)[0])
    sched, gen = make_lr_schedule(cfg), torch.Generator()
    got, want = [], []
    for i in range(30):
        batch = _batch(seed=i)
        jstate, jloss, _ = jstep(jstate, tuple(map(jnp.asarray, batch)),
                                 jax.random.key(i))
        loss, _ = trainer.train_step(state, tuple(map(torch.from_numpy,
                                                      batch)),
                                     cfg, sched, gen)
        got.append(float(loss))
        want.append(float(jloss))
    assert sched(29) > 0.99e-3      # the YAML's lr, barely decayed
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(
        model.quantizer._codebook.embed.numpy(),
        np.asarray(jstate.extra["vq"]["quantizer"]["codebook"]), atol=1e-4)


def test_trend_with_draws_at_the_yaml_lr_matches_jax():
    """k-means initialisation and the dead-code refresh on (the YAML's
    threshold), each package drawing from its own stream, 30 steps at lr
    1e-3 from the same weights on the same batches: the means of 10 steps'
    losses fall, and agree with the JAX package's within 1%."""
    geom = dict(n_electrodes=16, C=16, D=8, codebook_size=32)
    data = _tiny_data(64, seed=0, channels=16, t=96)
    xs = np.stack(data.inputs).astype(np.float32)

    def batch(i):
        x = xs[(8 * i) % len(xs):(8 * i) % len(xs) + 8]
        return x, np.zeros((8, 8), np.int64), np.zeros((8,), np.int32)

    cfg = _yaml_lr_cfg(30).replace(batch_size=8)
    spec = jtrainer.TrainableSpec(
        module=jvq_brain.SoundStream(jconfig.VQVAEConfig(**geom)),
        rng_names=("vq",), mutable=("vq",), needs_train_flag=True,
        needs_labels=False)
    jstate, tx = jtrainer.init_state(spec, cfg, batch(0))
    model = load_strict(SoundStream(tconfig.VQVAEConfig(**geom)),
                        export_soundstream({"params": jstate.params,
                                            "vq": jstate.extra["vq"]}))
    model.quantizer._codebook.initted.fill_(0.0)   # the exporter writes 1
    jstep = jtrainer.make_train_step(spec, tx, cfg)
    state = trainer.TrainState(model, trainer.make_optimizer(cfg, model)[0])
    sched, gen = make_lr_schedule(cfg), torch.Generator()
    got, want = [], []
    for i in range(30):
        b = batch(i)
        jstate, jloss, _ = jstep(jstate, tuple(map(jnp.asarray, b)),
                                 jax.random.key(i))
        loss, _ = trainer.train_step(state, tuple(map(torch.from_numpy, b)),
                                     cfg, sched, gen)
        got.append(float(loss))
        want.append(float(jloss))
    means = np.mean(np.reshape(got, (3, 10)), axis=1)
    jmeans = np.mean(np.reshape(want, (3, 10)), axis=1)
    assert means[0] > means[1] > means[2]
    assert jmeans[0] > jmeans[1] > jmeans[2]
    np.testing.assert_allclose(means, jmeans, rtol=1e-2)


@pytest.mark.parametrize("accum", [1, 2])
def test_logged_aux_terms_add_up_to_the_loss(accum):
    """rec_loss + commit_loss, as the trainer logs them (means over
    microbatches), is the step's loss."""
    _, _, _, model = _jax_pair()
    cfg = _train_cfg(grad_accum=accum)
    state = trainer.TrainState(model, trainer.make_optimizer(cfg, model)[0])
    loss, aux = trainer.train_step(
        state, tuple(map(torch.from_numpy, _batch())), cfg,
        make_lr_schedule(cfg), torch.Generator())
    np.testing.assert_allclose(float(aux["rec_loss"] + aux["commit_loss"]),
                               float(loss), rtol=1e-6)


def test_grad_accum_is_not_one_batch():
    """Threading is visible: two microbatches leave another codebook than
    one batch of both does (two EMA steps, not one)."""
    _, _, _, model = _jax_pair()
    _, _, _, other = _jax_pair()
    batch = tuple(map(torch.from_numpy, _batch()))
    for m, accum in ((model, 1), (other, 2)):
        cfg = _train_cfg(grad_accum=accum)
        trainer.loss_and_grads(trainer.TrainState(
            m, trainer.make_optimizer(cfg, m)[0]), batch, cfg)
    assert not torch.allclose(model.quantizer._codebook.embed,
                              other.quantizer._codebook.embed)


def test_remat_step_equals_plain_step():
    """remat recomputes the conv stacks only: the loss, every gradient and
    the codebook update (made once) equal a step without it."""
    results = []
    for remat in (False, True):
        _, _, _, model = _jax_pair()
        model.remat = remat
        cfg = _train_cfg()
        state = trainer.TrainState(model,
                                   trainer.make_optimizer(cfg, model)[0])
        loss = trainer.loss_and_grads(state, tuple(map(torch.from_numpy,
                                                       _batch())), cfg)
        results.append((float(loss),
                        {n: p.grad.clone()
                         for n, p in model.named_parameters()},
                        {n: b.clone() for n, b in model.named_buffers()}))
    (l0, g0, b0), (l1, g1, b1) = results
    assert l0 == l1
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=0, rtol=0, msg=n)
    for n in b0:
        torch.testing.assert_close(b1[n], b0[n], atol=0, rtol=0, msg=n)


def _tiny_data(n=8, seed=0, channels=GEOM["n_electrodes"], t=16):
    from frankenstein_tpu_torch.data import datasets, tokenizers
    tok = tokenizers.get_tokenizer(tokenizers.ByteTokenizer(eot_id=299))
    return datasets.BrainDataset.synthetic(n, seed=seed,
                                           tokenize_function=tok,
                                           n_electrodes=channels,
                                           max_input_len=t, max_tokens=8)


def test_checkpoint_and_resume_carry_the_codebook(tmp_path):
    cfg = _train_cfg(max_steps=2, eval_interval=2)
    tcfg = tconfig.VQVAEConfig(**{**GEOM, "threshold_ema_dead_code": 2.0})
    model = init_soundstream_(SoundStream(tcfg), seed=0)
    data = (_tiny_data(), _tiny_data(4, seed=1))
    state = trainer.run_train_model(model, data, cfg, save_folder=tmp_path)
    best = ckpt_lib.best_checkpoint(tmp_path / "vq")
    raw = ckpt_lib.load_raw_checkpoint(best)["model"]
    for name, buf in model.named_buffers():
        assert torch.equal(raw[name], buf), name
    assert float(raw["quantizer._codebook.initted"]) == 1.0

    fresh = init_soundstream_(SoundStream(tcfg), seed=1)
    assert not fresh.quantizer.initted()
    resumed = trainer.run_train_model(fresh, data, cfg.replace(max_steps=3),
                                      save_folder=tmp_path, resume=True)
    assert resumed.step == 3 and state.step == 2
    assert fresh.quantizer.initted()      # no k-means again after resume
    # the resumed step ran on the checkpoint's codebook: it moved from it
    assert not torch.equal(fresh.quantizer._codebook.embed,
                           raw["quantizer._codebook.embed"])


def _records(run_dir):
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_cli_trains_vqvae_by_flags(tmp_path):
    state = train_main([
        "--model", "vqvae", "--channels", "8", "--window", "16", "--data",
        "synthetic", "--synthetic-trials", "8", "--batch-size", "4",
        "--steps", "2", "--eval-interval", "2", "--warmup", "1",
        "--no-bf16", "--save-folder", str(tmp_path), "--exp-name", "vq",
        "--device", "cpu"])
    assert isinstance(state.model, SoundStream) and state.step == 2
    assert state.model.cfg == tconfig.VQVAEConfig(n_electrodes=8)
    assert state.model.quantizer.initted()
    doc = json.loads((tmp_path / "vq" / "model_config.json").read_text())
    assert doc["model"] == "vqvae"
    assert tconfig.VQVAEConfig.from_dict(doc["model_config"]) == \
        state.model.cfg
    assert list((tmp_path / "vq").glob("step_2_loss_*"))


def test_cli_trains_vqvae_from_a_yaml(tmp_path):
    cfg = tmp_path / "vq.yaml"
    cfg.write_text(TINY_VQ_YAML)
    state = train_main(["--config", str(cfg), "--window", "16", "--data",
                        "synthetic", "--synthetic-trials", "8",
                        "--save-folder", str(tmp_path), "--device", "cpu"])
    assert state.step == 3
    assert state.model.cfg.strides == (2, 2)      # a YAML list, as a tuple
    assert state.model.cfg.n_electrodes == 8      # the data's channels
    records = [r for r in _records(tmp_path / "vq") if "train/loss" in r]
    assert [r["step"] for r in records] == [1, 2, 3]
    for r in records[1:]:
        assert all(np.isfinite(r[k]) for k in AUX)
        assert "grad_norm" in r and "samples_per_sec" in r
        assert "mfu" not in r                    # no known peak on the CPU


def test_cli_logs_mfu_where_the_peak_is_known(tmp_path, monkeypatch):
    """With a peak (as on the H100), the trainer logs mfu = 3 x forward
    FLOPs a step over step time and peak."""
    from frankenstein_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "detect_peak_flops", lambda name=None: 1e12)
    cfg = tmp_path / "vq.yaml"
    cfg.write_text(TINY_VQ_YAML)
    train_main(["--config", str(cfg), "--window", "16", "--data",
                "synthetic", "--synthetic-trials", "8", "--save-folder",
                str(tmp_path), "--device", "cpu"])
    records = [r for r in _records(tmp_path / "vq") if "train/loss" in r]
    assert "mfu" not in records[0]                # warm-up step: no rate
    for r in records[1:]:
        want = (3 * profiling.vqvae_fwd_flops_per_sample(
            tconfig.VQVAEConfig(n_electrodes=8, C=8, D=4, codebook_size=16),
            t=16) * r["samples_per_sec"] / 1e12)
        np.testing.assert_allclose(r["mfu"], want, rtol=1e-6)


def test_vqvae_cli_needs_a_gpu_unless_asked_for_the_cpu(tmp_path):
    p = subprocess.run(
        [sys.executable, "-m", "frankenstein_tpu_torch.train", "--model",
         "vqvae", "--data", "synthetic", "--steps", "1", "--save-folder",
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 1 and "--device cpu" in p.stderr, p.stderr[-2000:]


def test_flops_per_sample_of_each_model():
    from frankenstein_tpu_torch.train.__main__ import flops_per_sample
    from frankenstein_tpu_torch.utils import profiling
    vq = tconfig.VQVAEConfig()
    assert flops_per_sample("vqvae", vq, 768) == \
        profiling.vqvae_fwd_flops_per_sample(vq, t=768)
    assert flops_per_sample("franky", tconfig.FrankyConfig(), 768) == \
        profiling.franky_fwd_flops_per_sample(tconfig.FrankyConfig())
    assert flops_per_sample("simple_mae", None, 768) == 0.0
