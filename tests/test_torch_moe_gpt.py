"""The MoE GPT and the MoE LLaMA of the port against the JAX package's on
the CPU (f32, weights JAX -> ``gpt_state_from_flax`` /
``llama_state_from_flax``), their decodes, and ``--model moe-gpt`` through
the train and submit CLIs at a tiny size."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.decode import sampling as jsampling
from frankenstein_tpu.models import gpt2 as jgpt2
from frankenstein_tpu.models import llama as jllama
from frankenstein_tpu.models.import_reference import export_gpt
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.decode import sampling
from frankenstein_tpu_torch.models import gpt2, llama
from frankenstein_tpu_torch.models.weights import (gpt_state_from_flax,
                                                   llama_state_from_flax,
                                                   load_strict)
from frankenstein_tpu_torch.train import trainer
from frankenstein_tpu_torch.train.__main__ import main as train_main
from tests.test_dress_rehearsal import TINY_YAML
from tests.test_torch_train_cli import tiny_mae_yaml

torch.set_num_threads(1)


def _gpt_cfg(mod, moe=4, cap=0.5):
    return mod.GPTConfig(block_size=32, vocab_size=96, n_layer=2, n_head=2,
                         n_embd=32, moe_experts=moe, moe_k=2,
                         moe_capacity=cap)


def _numpy(tree, router=4.0):
    """The params as numpy, every MoE router scaled so routing is decisive
    in both frameworks' rounding."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = jax.tree_util.tree_map(np.asarray, tree)
    for path, leaf in flat:
        if getattr(path[-1], "key", None) == "wg":
            node = out
            for k in path[:-1]:
                node = node[k.key]
            node["wg"] = np.asarray(leaf) * router
    return out


@pytest.fixture(scope="module")
def gpt_pair():
    rng = np.random.default_rng(0)
    jm = jgpt2.GPT(_gpt_cfg(jconfig))
    idx = rng.integers(0, 96, (4, 8)).astype(np.int32)
    prefix = rng.standard_normal((4, 3, 32)).astype(np.float32)
    params = _numpy(jm.init(jax.random.key(0), jnp.asarray(idx),
                            jnp.asarray(prefix)))
    tm = load_strict(gpt2.GPT(_gpt_cfg(tconfig)),
                     gpt_state_from_flax(params))
    return jm, params, tm, idx, prefix


def test_moe_gpt_loss_and_logits_match_jax(gpt_pair):
    """Capacity 0.5 drops choices in every block; the loss carries
    0.01 x the summed balancing losses."""
    jm, params, tm, idx, prefix = gpt_pair
    tgt = idx.copy()
    tgt[:, -2:] = jconfig.IGNORE_INDEX
    loss, logits = jm.apply(params, jnp.asarray(idx), jnp.asarray(prefix),
                            jnp.asarray(tgt))
    tloss, tlogits = tm(torch.from_numpy(idx).long(),
                        torch.from_numpy(prefix),
                        torch.from_numpy(tgt).long())
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)
    ce = gpt2.cross_entropy_ignore(tlogits[:, :-1],
                                   torch.from_numpy(tgt).long()[:, 1:])
    assert float(tloss - ce) > 0.01


def test_moe_gpt_greedy_and_beam_tokens_match_jax(gpt_pair):
    """Decode runs the module blocks (K2 takes the dense MLP only); the
    one-position MoE calls drop nothing."""
    jm, params, tm, idx, prefix = gpt_pair
    i0, p0 = idx[:, :2], prefix
    want = jsampling.generate(jm, params, jnp.asarray(i0), jnp.asarray(p0),
                              jax.random.key(1), max_new_tokens=5,
                              greedy=True)
    got = sampling.generate(tm, torch.from_numpy(i0).long(),
                            torch.from_numpy(p0), max_new_tokens=5,
                            greedy=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jt, js = jsampling.beam_search(jm, params, jnp.asarray(i0),
                                   jnp.asarray(p0), max_new_tokens=4,
                                   beam_width=3)
    tt, ts = sampling.beam_search(tm, torch.from_numpy(i0).long(),
                                  torch.from_numpy(p0), max_new_tokens=4,
                                  beam_width=3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)


def test_moe_lm_has_no_stacked_decode_weights(gpt_pair):
    """No K2 / w8a16 weights for an MoE GPT: bf16 serving gets None, int8
    raises, as the JAX package raises off its fused path."""
    tm = gpt_pair[2]
    assert sampling.decode_weights(tm, int8_weights=False) is None
    with pytest.raises(NotImplementedError, match="dense MLP"):
        sampling.decode_weights(tm, int8_weights=True)


def test_dense_gpt_state_from_flax_is_export_gpt():
    jm = jgpt2.GPT(_gpt_cfg(jconfig, moe=0))
    params = jm.init(jax.random.key(2), jnp.zeros((1, 4), jnp.int32))
    ours = gpt_state_from_flax(jax.tree_util.tree_map(np.asarray, params))
    theirs = export_gpt(params)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_moe_llama_loss_and_logits_match_jax():
    cfg_j = jllama.tiny_llama_config(moe_experts=4, moe_capacity=0.5)
    jm = jllama.Llama(cfg_j)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 128, (3, 10)).astype(np.int32)
    params = _numpy(jm.init(jax.random.key(0), jnp.asarray(idx)))
    tm = load_strict(
        llama.Llama(tconfig.tiny_llama_config(moe_experts=4,
                                              moe_capacity=0.5)),
        llama_state_from_flax(params["params"]))
    loss, logits = jm.apply(params, jnp.asarray(idx),
                            targets=jnp.asarray(idx))
    tloss, tlogits = tm(torch.from_numpy(idx).long(),
                        targets=torch.from_numpy(idx).long())
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)
    want = jsampling.generate(jm, params, jnp.asarray(idx[:, :3]), None,
                              jax.random.key(1), max_new_tokens=4,
                              greedy=True)
    got = sampling.generate(tm, torch.from_numpy(idx[:, :3]).long(), None,
                            max_new_tokens=4, greedy=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _moe_yaml() -> str:
    return (TINY_YAML.replace("model: franky", "model: moe-gpt")
            .replace("    n_embd: 16\n", "    n_embd: 16\n    moe_experts: 4\n"
                     "    moe_k: 2\n    moe_capacity: 1.25\n")
            .replace("train:\n", "train:\n  mesh_shape: [2, 4]\n"))


def test_moe_gpt_trains_serves_and_grafts_from_the_clis(tmp_path):
    """--model moe-gpt from its YAML (mesh [2, 4] asks for 8 ranks, so
    --mesh 1,1 on one device; without it the CLI exits with the cause), an
    MAE grafted in by --init-encoder-from, the run served by submit
    --run-dir with beams of 2; then by flags."""
    from frankenstein_tpu_torch import submit
    moe_cfg, mae_cfg = tmp_path / "moe.yaml", tmp_path / "mae.yaml"
    moe_cfg.write_text(_moe_yaml())
    mae_cfg.write_text(tiny_mae_yaml())
    logs = tmp_path / "logs"
    common = ["--data", "synthetic", "--synthetic-trials", "16",
              "--save-folder", str(logs), "--device", "cpu"]
    with pytest.raises(SystemExit, match="needs 8 ranks"):
        train_main(["--config", str(moe_cfg), *common])
    train_main(["--config", str(mae_cfg), "--exp-name", "mae", *common])
    state = train_main(["--config", str(moe_cfg), "--mesh", "1,1",
                        "--exp-name", "moe", "--init-encoder-from",
                        str(logs / "mae"), *common])
    assert state.step == 3 and state.model.cfg.gpt.moe_experts == 4
    doc = json.loads((logs / "moe" / "model_config.json").read_text())
    assert doc["model"] == "moe-gpt"
    mae = torch.load(next((logs / "mae").glob("step_*/state.pt")),
                     weights_only=True)["model"]
    assert "brain_model.encoder.transformer.emb.weight" in \
        state.model.state_dict()
    assert not torch.equal(
        mae["encoder.space_embedding"],
        torch.zeros_like(mae["encoder.space_embedding"]))
    out = submit.main(["--run-dir", str(logs / "moe"), "--data",
                       "synthetic", "--beam-width", "2", "--synthetic-trials",
                       "3", "--out", str(tmp_path / "sub.txt"), "--device",
                       "cpu"])
    assert len(out.read_text().splitlines()) == 3
    flags = train_main(["--model", "moe-gpt", "--window", "32", "--patch",
                        "8", "--channels", "8", "--moe-experts", "2",
                        "--moe-k", "1", "--moe-capacity", "2.0",
                        "--batch-size", "2", "--steps", "1", "--exp-name",
                        "flags", *common])
    gcfg = flags.model.cfg.gpt
    assert (gcfg.moe_experts, gcfg.moe_k, gcfg.moe_capacity) == (2, 1, 2.0)


def test_trainer_without_a_process_group_names_the_cause(tmp_path):
    """A mesh of more than one device, or FSDP, needs ranks (torchrun)."""
    from tests.torch_parallel_workers import _franky
    model = _franky()
    for kw, match in (({"mesh_shape": (2, 1)}, "needs 2 ranks"),
                      ({"fsdp": True}, "process group")):
        with pytest.raises(ValueError, match=match):
            trainer.setup_parallel(model, tconfig.TrainConfig(**kw),
                                   torch.device("cpu"))
