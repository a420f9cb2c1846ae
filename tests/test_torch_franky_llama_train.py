"""FrankyLlama training in the port against the JAX package, on the CPU:
the trainer's contract (``loss, logits = model(x, targets, train=...,
generator=..., date_info=...)``) with its loss and every gradient against
``jax.value_and_grad`` of the JAX FrankyLlama (session embedding and
per-sample ``date_info`` included), ``train`` and ``generator`` changing
nothing, remat giving the same gradients, an MAE's encoder grafted in
bitwise, and the train CLI (``--config`` with ``--init-encoder-from`` a
tiny MAE run, then ``submit --run-dir``; ``--model franky-llama`` by
flags). float32; inputs from numpy seeds."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu.models import llama as jllama
from frankenstein_tpu.models.franky import FrankyLlama as JFrankyLlama
from frankenstein_tpu.models.franky import \
    FrankyLlamaConfig as JFrankyLlamaConfig
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch import submit
from frankenstein_tpu_torch.models.franky import FrankyLlama
from frankenstein_tpu_torch.models.weights import (date_embedding_state,
                                                   init_franky_llama_,
                                                   load_strict)
from frankenstein_tpu_torch.train import checkpoints as ckpt_lib
from frankenstein_tpu_torch.train import trainer
from frankenstein_tpu_torch.train.__main__ import main as train_main
from tests.test_torch_franky_llama import export_franky_llama, tiny_cfg
from tests.test_torch_train import (_train_mae, tiny_batch, tiny_data,
                                    train_cfg)
from tests.test_torch_train_cli import tiny_mae_yaml

torch.set_num_threads(1)

LOSS_TOL = 1e-6    # f32 on both sides
GRAD_TOL = 1e-5    # relative to each gradient's max |value|, as Franky's
SESSIONS = 3
DATES = np.array([4, 0, 3, 6], np.int32)   # rows 1, 0, 0, 0; 2 unused


def _cfgs(sessions=0):
    """(jax config, port config) of the tiny composite of
    test_torch_franky_llama.py, with ``sessions`` session rows."""
    out = []
    for mod, cls in ((jllama, JFrankyLlamaConfig),
                     (tconfig, tconfig.FrankyLlamaConfig)):
        cfg = tiny_cfg(mod, cls)
        enc = cfg.brain.encoder.replace(n_sessions=sessions)
        out.append(cfg.replace(brain=cfg.brain.replace(encoder=enc)))
    return out


def _state(tree) -> dict:
    out = export_franky_llama(tree)
    out.update(date_embedding_state(
        jax.tree_util.tree_map(np.asarray,
                               tree["params"]["brain_model"]["encoder"]),
        "brain_model.encoder."))
    return out


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs(SESSIONS)
    jmodel = JFrankyLlama(jcfg)
    rng = np.random.default_rng(0)
    x, y = tiny_batch()
    params = jmodel.init(jax.random.key(0), jnp.asarray(x[:1]),
                         jnp.asarray(y[:1]))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    return jmodel, params, tcfg, (x, y, DATES)


def _port(pair):
    return load_strict(FrankyLlama(pair[2]), _state(pair[1]))


def test_trainer_step_gradients_match_jax(pair):
    """``trainer.loss_and_grads`` on (x, targets, date_info): the loss and
    every gradient (the session rows too, unused rows zero) against the
    JAX FrankyLlama's, which the JAX trainer calls with date_info=d."""
    jmodel, params, _, (x, y, d) = pair

    def loss_fn(p):
        return jmodel.apply(p, jnp.asarray(x), jnp.asarray(y),
                            date_info=jnp.asarray(d))[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = _port(pair)
    cfg = train_cfg()
    state = trainer.TrainState(model, trainer.make_optimizer(cfg, model)[0])
    loss = trainer.loss_and_grads(state, tuple(map(torch.from_numpy,
                                                   (x, y, d))), cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
    want = _state(jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w,
                                   atol=GRAD_TOL * max(np.abs(w).max(), 1e-3),
                                   err_msg=name)
    rows = got["brain_model.encoder.date_embedding"].abs().sum(-1)
    assert rows[2] == 0 and (rows[[0, 1]] > 0).all()
    trainer.apply_update(state, cfg, lambda step: cfg.learning_rate)
    assert state.step == 1


def test_train_and_generator_change_nothing_and_remat_matches(pair):
    """The LLaMA has no dropout (the JAX spec gives it no train flag and
    no rngs); remat recomputes the encoder's and the LLaMA's blocks."""
    x, y, d = map(torch.from_numpy, pair[3])
    model = _port(pair)
    plain = model(x, y, date_info=d)[0]
    trained = model(x, y, train=True, date_info=d,
                    generator=torch.Generator().manual_seed(3))[0]
    assert torch.equal(plain, trained)
    grads = []
    for remat in (False, True):
        model.zero_grad()
        model.remat = remat
        model(x, y, train=True, date_info=d)[0].backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_graft_copies_the_mae_encoder_into_franky_llama(tmp_path):
    mae = _train_mae(tmp_path).model
    model = init_franky_llama_(FrankyLlama(_cfgs()[1]), seed=4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ckpt_lib.graft_encoder_from_mae(tmp_path / "mae", model)
    want = mae.encoder.state_dict()
    for name, value in model.state_dict().items():
        if name.startswith("brain_model.encoder."):
            assert torch.equal(value, want[name[len("brain_model.encoder."):]])
        else:
            assert torch.equal(value, before[name]), name


def test_trains_through_the_trainer(tmp_path):
    """Three steps of run_train_model on batches that carry date_info (the
    loader's third array), with an eval and a checkpoint."""
    model = init_franky_llama_(FrankyLlama(_cfgs(SESSIONS)[1]), seed=0)
    state = trainer.run_train_model(
        model, (tiny_data(), tiny_data(8, seed=1)),
        train_cfg(max_steps=3, eval_interval=2), save_folder=tmp_path)
    assert state.step == 3
    assert ckpt_lib.best_checkpoint(tmp_path / "t").name.startswith("step_2")


TINY_FL_YAML = """\
model: franky-llama
model_config:
  brain:
    encoder: {window_size: 768, n_electrodes: 256, patch_size: 192, dim: 16,
              n_layers: 1, head_dim: 8, hidden_dim: 32, n_heads: 2,
              n_kv_heads: 2, n_dec_layers: 1, decoder_dim: 16}
    n_output_tokens: 4
    output_dim: 16
    dim: 16
    n_layers: 1
    head_dim: 8
    hidden_dim: 32
    n_heads: 2
    n_kv_heads: 2
  lm: {vocab_size: 50304, dim: 16, n_layers: 1, n_heads: 2, n_kv_heads: 1,
       hidden_dim: 32, max_seq_len: 64, tie_embeddings: true}
train: {batch_size: 4, max_steps: 3, eval_interval: 2, warmup_iters: 0,
        use_scheduler: false, log_interval: 1}
"""


def test_cli_trains_grafts_and_serves_franky_llama(tmp_path, monkeypatch):
    """MAE pretraining, then FrankyLlama from its YAML with the MAE's
    encoder grafted (equal to the MAE checkpoint's bitwise before the
    first step), then ``submit --run-dir`` over its best checkpoint."""
    (tmp_path / "mae.yaml").write_text(tiny_mae_yaml())
    (tmp_path / "fl.yaml").write_text(TINY_FL_YAML)
    logs = tmp_path / "logs"
    common = ["--data", "synthetic", "--synthetic-trials", "16",
              "--save-folder", str(logs), "--device", "cpu"]
    mae = train_main(["--config", str(tmp_path / "mae.yaml"), "--exp-name",
                      "mae", *common])
    mae_encoder = ckpt_lib.load_raw_checkpoint(logs / "mae")["model"]
    seen = {}
    real = trainer.run_train_model

    def snapshot(model, *a, **kw):
        seen.update({k: v.clone() for k, v in
                     model.brain_model.encoder.state_dict().items()})
        return real(model, *a, **kw)

    monkeypatch.setattr(trainer, "run_train_model", snapshot)
    state = train_main(["--config", str(tmp_path / "fl.yaml"), "--exp-name",
                        "fl", "--init-encoder-from", str(logs / "mae"),
                        *common])
    assert state.step == 3 and isinstance(state.model, FrankyLlama)
    assert mae.step == 3
    assert set(seen) == {k[len("encoder."):] for k in mae_encoder
                         if k.startswith("encoder.")}
    for k, v in seen.items():
        assert torch.equal(v, mae_encoder["encoder." + k]), k
    doc = json.loads((logs / "fl" / "model_config.json").read_text())
    assert doc["model"] == "franky-llama"
    assert doc["model_config"]["lm"]["dim"] == 16

    out = submit.main(["--run-dir", str(logs / "fl"), "--data", "synthetic",
                       "--synthetic-trials", "3", "--beam-width", "2",
                       "--batch-size", "3", "--out",
                       str(tmp_path / "sub.txt"), "--device", "cpu"])
    assert len(out.read_text().splitlines()) == 3


def test_cli_builds_franky_llama_from_flags(tmp_path):
    """Flags give FrankyLlamaConfig(brain=PerceiverConfig(encoder of the
    flags, n_output_tokens=32, output_dim=1024)) and the default LLaMA, as
    the JAX train.py does (no step is taken: the LLaMA is ~110M)."""
    state = train_main(["--model", "franky-llama", "--window", "32",
                        "--channels", "8", "--patch", "8", "--data",
                        "synthetic", "--synthetic-trials", "8",
                        "--batch-size", "2", "--steps", "0", "--exp-name",
                        "flags", "--save-folder", str(tmp_path),
                        "--device", "cpu"])
    cfg = state.model.cfg
    want = tconfig.FrankyLlamaConfig(brain=tconfig.PerceiverConfig(
        encoder=tconfig.MAEConfig(window_size=32, n_electrodes=8,
                                  patch_size=8),
        n_output_tokens=32, output_dim=1024))
    assert cfg == want and state.step == 0
    doc = json.loads((tmp_path / "flags" / "model_config.json").read_text())
    assert tconfig.FrankyLlamaConfig.from_dict(doc["model_config"]) == want


def test_submit_refuses_a_non_composite_run(tmp_path):
    (tmp_path / "model_config.json").write_text(json.dumps(
        {"model": "mae", "model_config": {}}))
    with pytest.raises(SystemExit, match="franky, franky-llama"):
        submit.build_from_run_dir(tmp_path)
