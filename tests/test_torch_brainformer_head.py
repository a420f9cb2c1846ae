"""The port's BrainFormer (a BrainEncoder with the L1 regression head) and
the encoder's session embedding against the JAX package's, on the CPU: the
BrainFormer's loss, prediction and every gradient with float targets
(weights from ``export_brain_encoder(..., head="to_motion",
prefix="brain.")``), the session embedding in the MAE and in Franky with
per-sample ``date_info`` (its row from the JAX parameters by name, the
rows a batch uses getting gradients and the rest none), the seeded
initial weights, and the train CLI's refusal of ``--model brainformer``
with the JAX package's fault. float32 on both sides; inputs from numpy
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.models import brainformer as jbrain
from frankenstein_tpu.models.franky import Franky as JFranky
from frankenstein_tpu.models.import_reference import (export_brain_encoder,
                                                      export_franky,
                                                      export_mae)
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.models import brainformer as tbrain
from frankenstein_tpu_torch.models.franky import Franky
from frankenstein_tpu_torch.models.weights import (date_embedding_state,
                                                   init_brainformer_,
                                                   init_franky_, load_strict)
from frankenstein_tpu_torch.train.__main__ import main as train_main
from tests.test_torch_train import tiny_batch, tiny_cfg

torch.set_num_threads(1)

LOSS_TOL = 1e-5    # f32 on both sides, other summation orders
GRAD_TOL = 1e-5    # relative to each gradient's max |value|, as Franky's

ENC = dict(window_size=32, n_electrodes=8, patch_size=8, dim=16,
           n_layers=1, head_dim=8, hidden_dim=32, n_heads=2, n_kv_heads=2,
           n_dec_layers=1, decoder_dim=16)
SESSIONS = 5
DATES = np.array([7, 1, 12, 3], np.int32)   # rows 2, 1, 2, 3; 0 and 4 unused


def _perceiver(mod, **enc):
    return mod.PerceiverConfig(
        encoder=mod.MAEConfig(**{**ENC, **enc}), n_output_tokens=4,
        output_dim=12, dim=16, n_layers=1, head_dim=8, hidden_dim=32,
        n_heads=2, n_kv_heads=2)


def _perturb(params, rng, scale=0.05):
    """Every leaf moved, so zero biases, zero queries and zero session rows
    are tested."""
    return jax.tree_util.tree_map(
        lambda a: a + scale * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _check_grads(model, want: dict):
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name].numpy(), w,
                                   atol=GRAD_TOL * max(np.abs(w).max(), 1e-3),
                                   err_msg=name)


def _brainformer_state(params) -> dict:
    p = params["params"]["brain"]
    state = export_brain_encoder({"params": p}, head="to_motion",
                                 prefix="brain.")
    state.update(date_embedding_state(p["encoder"], "brain.encoder."))
    return state


@pytest.mark.parametrize("sessions", [0, SESSIONS])
def test_brainformer_with_float_targets_matches_jax(sessions):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 8)).astype(np.float32)
    targets = rng.standard_normal((4, 4, 12)).astype(np.float32)
    dates = DATES if sessions else None
    jmodel = jbrain.BrainFormer(_perceiver(jconfig, n_sessions=sessions))
    params = _perturb(jmodel.init(jax.random.key(0), jnp.asarray(x[:1])),
                      rng)

    def loss_fn(p):
        return jmodel.apply(p, jnp.asarray(x), jnp.asarray(targets),
                            date_info=dates)

    (jloss, jpred), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    model = load_strict(tbrain.BrainFormer(
        _perceiver(tconfig, n_sessions=sessions)), _brainformer_state(params))
    loss, pred = model(torch.from_numpy(x), torch.from_numpy(targets),
                       date_info=None if dates is None
                       else torch.from_numpy(dates))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred),
                               atol=LOSS_TOL)
    loss.backward()
    _check_grads(model, _brainformer_state(jgrads))
    none, again = model(torch.from_numpy(x), date_info=None if dates is None
                        else torch.from_numpy(dates))
    assert none is None and torch.equal(again, pred)


def test_brainformer_state_names_are_the_references():
    model = tbrain.BrainFormer(_perceiver(tconfig))
    names = set(model.state_dict())
    assert "brain.perceiver.to_motion.weight" in names
    assert not any("to_words" in n for n in names)
    jmodel = jbrain.BrainFormer(_perceiver(jconfig))
    params = jmodel.init(jax.random.key(0), jnp.ones((1, 32, 8)))
    assert names == set(_brainformer_state(params))


def test_seeded_brainformer_init():
    a = init_brainformer_(tbrain.BrainFormer(
        _perceiver(tconfig, n_sessions=SESSIONS)), seed=3)
    b = init_brainformer_(tbrain.BrainFormer(
        _perceiver(tconfig, n_sessions=SESSIONS)), seed=3)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert not a.brain.learnable_queries.any()
    date = a.brain.encoder.date_embedding.detach()
    assert date.shape == (SESSIONS, 16) and 0.01 < float(date.std()) < 0.03
    assert abs(float(a.brain.encoder.space_embedding.detach().std()) - 1) < .35


def _mae_pair(rng):
    cfg = dict(ENC, n_sessions=SESSIONS)
    jmodel = jbrain.MAE(jconfig.MAEConfig(**cfg))
    key = jax.random.key(1)
    params = _perturb(jmodel.init({"params": key, "mask": key},
                                  jnp.ones((1, 32, 8)), rng=key), rng)
    state = export_mae(params)
    state.update(date_embedding_state(params["params"]["encoder"],
                                      "encoder."))
    return jmodel, params, load_strict(tbrain.MAE(tconfig.MAEConfig(**cfg)),
                                       state)


def test_session_embedding_in_the_mae_matches_jax():
    """Each sample's row date_info % n_sessions is added to its kept
    tokens; the rows no sample uses get a zero gradient."""
    rng = np.random.default_rng(1)
    jmodel, params, model = _mae_pair(rng)
    x = rng.standard_normal((4, 32, 8)).astype(np.float32)
    key = jax.random.key(9)
    idx = tuple(torch.from_numpy(np.array(a)).long() for a in
                jbrain.masking_indices(key, 4, jmodel.cfg.block_size, 0.75))

    def loss_fn(p):
        return jmodel.apply(p, jnp.asarray(x), date_info=DATES, rng=key)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    loss, _ = model(torch.from_numpy(x), date_info=torch.from_numpy(DATES),
                    indices=idx)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    loss.backward()
    want = export_mae(jgrads)
    want.update(date_embedding_state(jgrads["params"]["encoder"],
                                     "encoder."))
    _check_grads(model, want)
    rows = model.encoder.date_embedding.grad.abs().sum(-1)
    used = sorted(set(int(d) % SESSIONS for d in DATES))
    assert (rows[used] > 0).all()
    assert not rows[[r for r in range(SESSIONS) if r not in used]].any()
    other, _ = model(torch.from_numpy(x), date_info=torch.from_numpy(
        DATES + 1), indices=idx)
    assert float(other.detach()) != float(loss.detach())


def test_session_embedding_in_franky_matches_jax():
    """Franky's loss and every gradient with per-sample date_info, its
    session rows carried across by name (the exporter drops them)."""
    rng = np.random.default_rng(2)
    x, y = tiny_batch()
    cfg = lambda mod: tiny_cfg(mod).replace(brain=tiny_cfg(mod).brain.replace(
        encoder=tiny_cfg(mod).brain.encoder.replace(n_sessions=SESSIONS)))
    jmodel = JFranky(cfg(jconfig))
    params = _perturb(jmodel.init(jax.random.key(0), jnp.asarray(x[:1]),
                                  jnp.asarray(y[:1])), rng)

    def state_of(tree):
        out = export_franky(tree)
        out.update(date_embedding_state(
            tree["params"]["brain_model"]["encoder"],
            "brain_model.encoder."))
        return out

    def loss_fn(p):
        return jmodel.apply(p, jnp.asarray(x), jnp.asarray(y),
                            date_info=DATES)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = load_strict(Franky(cfg(tconfig)), state_of(params))
    loss, _ = model(torch.from_numpy(x), torch.from_numpy(y),
                    date_info=torch.from_numpy(DATES))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-6)
    loss.backward()
    want = state_of(jgrads)
    del want["llm_model.lm_head.weight"]     # tied: wte's gradient has it
    _check_grads(model, want)
    seeded = init_franky_(Franky(cfg(tconfig)), seed=0)
    date = seeded.brain_model.encoder.date_embedding.detach()
    assert 0.01 < float(date.std()) < 0.03


def test_no_session_embedding_ignores_date_info():
    model = tbrain.MAE(tconfig.MAEConfig(**ENC))
    assert not hasattr(model.encoder, "date_embedding")
    x = torch.randn(2, 32, 8, generator=torch.Generator().manual_seed(0))
    gen = lambda: torch.Generator().manual_seed(1)
    assert torch.equal(model(x, generator=gen())[0],
                       model(x, generator=gen(),
                             date_info=torch.tensor([3, 4]))[0])


def test_cli_refuses_brainformer_with_the_jax_finding():
    with pytest.raises(SystemExit, match=r"--model brainformer is refused: "
                       r".*token ids.*float targets.*Incompatible shapes for "
                       r"broadcasting: \(2, 25, 50257\), \(2, 25\)"):
        train_main(["--model", "brainformer", "--data", "synthetic"])
