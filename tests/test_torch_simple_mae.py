"""The port's SimpleMAE against the JAX package's, on the CPU: the loss,
``return_preds`` and every gradient of a tiny SimpleMAE given the same
mask indices (drawn by the JAX package from its rng) and
``export_simple_mae`` weights, on windows whose padded (all-zero)
timesteps fall among both the kept and the masked ones; the generator's
mask, the seeded initial weights, remat, the K9 RMSNorm route a bf16
forward takes, and the train CLI (``--model simple_mae`` by flags, a
matching YAML, and the refusal of a YAML whose ``patch_size`` is not the
data's channel count). float32 on both sides; inputs from numpy seeds."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.models import brainformer as jbrain
from frankenstein_tpu.models import simple_mae as jsimple
from frankenstein_tpu.models.import_reference import export_simple_mae
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.models.simple_mae import SimpleMAE
from frankenstein_tpu_torch.models.weights import (init_simple_mae_,
                                                   load_strict)
from frankenstein_tpu_torch.ops.cuda import fused_mlp
from frankenstein_tpu_torch.train.__main__ import main as train_main

torch.set_num_threads(1)

LOSS_TOL = 1e-5    # f32 on both sides, other summation orders
GRAD_TOL = 1e-4    # absolute, the MAE's gradients' tolerance

ENC = dict(block_size=16, patch_size=8, dim=16, n_layers=2, head_dim=8,
           hidden_dim=32, n_heads=2, n_kv_heads=2)
DEC = dict(dim=24, n_layers=1, head_dim=8, hidden_dim=32, n_heads=3,
           n_kv_heads=3)


def _configs(mod, **dec):
    return (mod.SimpleEncoderConfig(**ENC),
            mod.SimpleMAEConfig(**{**DEC, **dec}))


def _pair(seed=0, batch=2, t=16):
    """(jax module, perturbed jax params, port SimpleMAE with the same
    weights, x [B, T, C] float32)."""
    rng = np.random.default_rng(seed)
    jmodel = jsimple.SimpleMAE(*_configs(jconfig))
    x = rng.standard_normal((batch, t, ENC["patch_size"])).astype(np.float32)
    key = jax.random.key(seed)
    params = jmodel.init({"params": key, "mask": key}, jnp.asarray(x[:1]),
                         rng=key)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    model = load_strict(SimpleMAE(*_configs(tconfig)),
                        export_simple_mae(params))
    return jmodel, params, model, x


def _indices(key, batch, t, ratio):
    """The JAX package's mask draw, as numpy (masked, kept)."""
    return tuple(np.array(a) for a in jbrain.masking_indices(key, batch, t,
                                                             ratio))


def _pad_some(x, idx):
    """Zero one kept and one masked timestep of every sample, and the last
    timestep, so padding falls on both sides of the mask."""
    x = x.copy()
    masked, kept = idx
    for i in range(x.shape[0]):
        x[i, [masked[i, 0], kept[i, -1], x.shape[1] - 1]] = 0.0
    return x


def _run_both(jmodel, params, model, x, key, ratio=None, preds=False):
    ratio = jmodel.dec_cfg.masking_ratio if ratio is None else ratio
    idx = _indices(key, x.shape[0], x.shape[1], ratio)
    x = _pad_some(x, idx)
    want = jmodel.apply(params, jnp.asarray(x), rng=key, masking_ratio=ratio,
                        return_preds=preds)
    got = model(torch.from_numpy(x),
                indices=tuple(torch.from_numpy(a).long() for a in idx),
                masking_ratio=ratio, return_preds=preds)
    return x, idx, want, got


@pytest.mark.parametrize("ratio", [None, 0.5])
def test_loss_and_predictions_match_jax(ratio):
    jmodel, params, model, x = _pair(seed=1)
    key = jax.random.key(7)
    x, idx, (jloss, jrecon, jbinary), (loss, recon, binary) = _run_both(
        jmodel, params, model, x, key, ratio, preds=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    assert recon.shape == binary.shape == x.shape
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(jrecon),
                               atol=LOSS_TOL)
    np.testing.assert_array_equal(binary.numpy(), np.asarray(jbinary))
    plain, none = model(torch.from_numpy(x), indices=tuple(
        torch.from_numpy(a).long() for a in idx), masking_ratio=ratio)
    assert none is None and torch.equal(plain, loss)


def test_padded_timesteps_leave_the_loss():
    """The loss averages the masked timesteps that are not padding: a
    window whose masked timesteps are all padding has loss 0 (the clamped
    denominator), and a padded timestep's prediction does not move it."""
    jmodel, params, model, x = _pair(seed=2, batch=1)
    idx = _indices(jax.random.key(3), 1, 16, 0.75)
    x[0, idx[0][0]] = 0.0
    t_idx = tuple(torch.from_numpy(a).long() for a in idx)
    loss = float(model(torch.from_numpy(x), indices=t_idx)[0].detach())
    want = jmodel.apply(params, jnp.asarray(x), rng=jax.random.key(3))[0]
    np.testing.assert_allclose(loss, float(want), rtol=LOSS_TOL)
    x_all = x.copy()
    x_all[0, idx[0]] = 0.0
    zero = model(torch.from_numpy(x_all), indices=t_idx)[0].detach()
    assert float(zero) == 0.0


@pytest.mark.parametrize("remat", [False, True])
def test_every_gradient_matches_jax(remat):
    """Both samples, padding among the kept and masked timesteps (kept
    padded rows attend to nothing and average their values); remat gives
    the same gradients."""
    jmodel, params, model, x = _pair(seed=3)
    key = jax.random.key(11)
    idx = _indices(key, 2, 16, 0.75)
    x = _pad_some(x, idx)
    jgrads = jax.grad(lambda p: jmodel.apply(p, jnp.asarray(x), rng=key)[0])(
        params)
    want = export_simple_mae(jgrads)
    model.remat = remat
    loss, _ = model(torch.from_numpy(x),
                    indices=tuple(torch.from_numpy(a).long() for a in idx))
    loss.backward()
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=GRAD_TOL,
                                   err_msg=name)


def test_shorter_window_than_block_size():
    """T < block_size: the decoder's position rows and the rope table are
    the first T (prefix), as in the JAX package."""
    jmodel, params, model, x = _pair(seed=4, t=12)
    key = jax.random.key(5)
    _, _, (jloss, _, _), (loss, _, _) = _run_both(jmodel, params, model, x,
                                                  key, preds=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)


def test_draws_its_mask_from_the_generator():
    _, _, model, x = _pair(seed=5)
    xt = torch.from_numpy(x)
    run = lambda seed: float(model(
        xt, generator=torch.Generator().manual_seed(seed))[0].detach())
    assert run(5) == run(5) and run(5) != run(6)


def test_seeded_init_scales():
    model = init_simple_mae_(SimpleMAE(*_configs(tconfig)), seed=0)
    again = init_simple_mae_(SimpleMAE(*_configs(tconfig)), seed=0)
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
    assert set(model.state_dict()) == set(export_simple_mae(
        jsimple.SimpleMAE(*_configs(jconfig)).init(
            {"params": jax.random.key(0), "mask": jax.random.key(0)},
            jnp.ones((1, 16, 8)), rng=jax.random.key(0))))
    assert torch.equal(model.encoder.transformer["h"][0].ln_1.weight,
                       torch.ones(ENC["dim"]))
    assert not model.to_signals.bias.any()
    emb = model.encoder.transformer["emb"].weight
    assert abs(float(emb.std()) * ENC["patch_size"] ** 0.5 - 1) < 0.3


def test_bf16_forward_runs_k9_rmsnorm_on_the_encoder_only(monkeypatch):
    """Under bf16 compute the encoder's stream is bf16, so each of its
    blocks takes K9's RMSNorm route (the twin here); the decoder's stream
    is f32, because the mask token takes the dtype of the encoder's
    LayerNorm output (f32 weights), so K9's gate refuses its blocks, as
    the JAX package's does."""
    kinds = []
    real = fused_mlp.FusedNormSwiGLU.apply
    monkeypatch.setattr(fused_mlp.FusedNormSwiGLU, "apply",
                        lambda *a: kinds.append(a[-1]) or real(*a))
    model = init_simple_mae_(SimpleMAE(*_configs(tconfig),
                                       dtype=torch.bfloat16), seed=1)
    x = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(0))
    loss, _ = model(x.to(torch.bfloat16),
                    generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(loss)
    assert kinds == ["rmsnorm"] * ENC["n_layers"]


def _cli(tmp_path, *args):
    return train_main(["--data", "synthetic", "--synthetic-trials", "8",
                       "--batch-size", "4", "--steps", "2",
                       "--eval-interval", "2", "--warmup", "0",
                       "--save-folder", str(tmp_path), "--device", "cpu",
                       *args])


def test_cli_trains_simple_mae_by_flags(tmp_path):
    state = _cli(tmp_path, "--model", "simple_mae", "--window", "24",
                 "--channels", "16", "--exp-name", "smae")
    assert state.step == 2 and isinstance(state.model, SimpleMAE)
    enc, dec = state.model.enc_cfg, state.model.dec_cfg
    assert (enc.block_size, enc.patch_size, enc.dim, enc.n_layers) == (
        24, 16, 256, 6) and dec == tconfig.SimpleMAEConfig()
    doc = json.loads((tmp_path / "smae" / "model_config.json").read_text())
    assert doc["model"] == "simple_mae"
    assert doc["model_config"] == [enc.to_dict(), dec.to_dict()]
    val = [json.loads(r)["val/loss"] for r in
           (tmp_path / "smae" / "metrics.jsonl").read_text().splitlines()
           if "val/loss" in r]
    assert len(val) == 1 and np.isfinite(val[0])


TINY_SIMPLE_YAML = """\
model: simple_mae
model_config:
  encoder: {block_size: 24, patch_size: 16, dim: 16, n_layers: 1,
            head_dim: 8, hidden_dim: 32, n_heads: 2, n_kv_heads: 2}
  decoder: {dim: 16, n_layers: 1, head_dim: 8, hidden_dim: 32, n_heads: 2,
            n_kv_heads: 2, masking_ratio: 0.5}
train: {batch_size: 4, max_steps: 2, eval_interval: 2, warmup_iters: 0}
"""


def test_cli_trains_a_matching_simple_mae_yaml(tmp_path):
    cfg = tmp_path / "smae.yaml"
    cfg.write_text(TINY_SIMPLE_YAML)
    state = _cli(tmp_path, "--config", str(cfg), "--window", "24",
                 "--channels", "16", "--exp-name", "y")
    assert state.step == 2
    assert state.model.dec_cfg.masking_ratio == 0.5


@pytest.mark.parametrize("argv,match", [
    (["--config", "configs/simple_mae.yaml"],
     r"patch_size 128 is not the data's channel count 256.*TypeError: sub "
     r"got incompatible shapes \(2, 576, 128\), \(2, 576, 256\)"),
    (["--config", "{tiny}", "--window", "32", "--channels", "16"],
     "block_size 24 is shorter than the data's window 32")])
def test_cli_refuses_a_simple_mae_yaml_off_the_data(tmp_path, argv, match):
    """The JAX train.py takes no data geometry from a simple_mae YAML and
    fails in the loss; the port exits before it builds anything, naming
    the mismatch."""
    tiny = tmp_path / "smae.yaml"
    tiny.write_text(TINY_SIMPLE_YAML)
    argv = [a.format(tiny=tiny) for a in argv]
    with pytest.raises(SystemExit, match=match):
        _cli(tmp_path, *argv)
    assert not list(tmp_path.glob("*/model_config.json"))
