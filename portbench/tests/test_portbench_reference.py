"""The frozen float32 reference agrees with the port's CPU path (its
kernels' plain twins) at tiny sizes, all in float32."""

import copy

import pytest
import torch

from portbench import weights
from portbench.reference import franky as franky_ref
from portbench.reference import mae as mae_ref
from portbench.reference import optim
from portbench.tests import tiny


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture
def franky():
    from frankenstein_tpu_torch.config import FrankyConfig
    from frankenstein_tpu_torch.models.franky import Franky
    mc = copy.deepcopy(tiny.FRANKY["model_config"])
    model = Franky(FrankyConfig.from_dict(mc))
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    params = weights.make(shapes, franky_ref.init_rule, 3, "cpu",
                          n_layer=mc["gpt"]["n_layer"])
    weights.load(model, params)
    return model, params, mc


def test_brain_prefix_matches(franky):
    model, params, mc = franky
    x = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(0))
    got = model.encode(x)
    want = franky_ref.brain(x, params, mc["brain"], chunk=48)
    assert _rel(got, want) < 1e-5


def test_served_logits_match_the_cached_decode(franky):
    """Prefill and decode steps through the cache give the teacher-forced
    reference's logits, position by position."""
    from frankenstein_tpu_torch.decode import sampling
    model, params, mc = franky
    x = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(1))
    prefix = model.encode(x)
    idx0 = torch.full((2, 1), franky_ref.EOT, dtype=torch.long)
    logits, cache, length = sampling._prefill(model, idx0, prefix, 4, False)
    steps, toks = [logits], []
    for _ in range(3):
        tok = torch.argmax(steps[-1], dim=-1)
        toks.append(tok)
        logits, cache, length = model.decode_step(tok, cache, length)
        steps.append(logits)
    toks.append(torch.argmax(steps[-1], dim=-1))
    got = torch.stack(steps, dim=1)
    want = franky_ref.served_logits(x, torch.stack(toks, dim=1), params, mc)
    assert _rel(got, want) < 1e-5


def test_franky_loss_matches(franky):
    model, params, mc = franky
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(3, 64, 16, generator=gen)
    y = torch.randint(0, 50256, (3, 6), generator=gen)
    y[0, 4:] = franky_ref.IGNORE
    with torch.no_grad():
        loss, _ = model(x, y)
    total, count = franky_ref.loss_sum(x, y, params, mc)
    assert float(loss) == pytest.approx(float(total) / count, rel=1e-5)


def test_mae_loss_and_masks_match():
    from frankenstein_tpu_torch.config import MAEConfig
    from frankenstein_tpu_torch.models.brainformer import MAE
    mc = copy.deepcopy(tiny.MAE["model_config"])
    model = MAE(MAEConfig.from_dict(mc))
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    params = weights.make(shapes, mae_ref.init_rule, 4, "cpu")
    weights.load(model, params)
    x = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        loss, _ = model(x, generator=torch.Generator().manual_seed(9))
    masked, kept = mae_ref.masks(torch.Generator().manual_seed(9), 2, 128,
                                 0.75, "cpu")
    total, count = mae_ref.loss_sum(x, masked, kept, params, mc, chunk=40)
    assert float(loss) == pytest.approx(float(total) / count, rel=1e-5)


def test_adamw_matches_the_trainers_update():
    """The plain update against the trainer's (value clip, schedule,
    torch AdamW) over three updates."""
    from frankenstein_tpu_torch.config import TrainConfig
    from frankenstein_tpu_torch.train import trainer
    train = {"learning_rate": 1e-2, "weight_decay": 0.1, "warmup_iters": 2,
             "lr_decay_iters": 10, "grad_clip": 0.05}
    tcfg = TrainConfig.from_dict(train)
    gen = torch.Generator().manual_seed(5)
    w = torch.randn(4, 3, generator=gen)
    model = torch.nn.Linear(3, 4, bias=False)
    with torch.no_grad():
        model.weight.copy_(w)
    opt, sched = trainer.make_optimizer(tcfg, model)
    state = trainer.TrainState(model, opt)
    params, adam = {"w": w.clone()}, {}
    for s in range(3):
        g = torch.randn(4, 3, generator=gen) * 0.1
        model.weight.grad = g.clone()
        trainer.apply_update(state, tcfg, sched)
        optim.adamw_update(params, {"w": g}, adam, train, s)
        assert optim.lr_at(train, s) == pytest.approx(sched(s))
    assert torch.allclose(model.weight.detach(), params["w"], atol=1e-7)


@pytest.mark.parametrize("width", [1, 3])
def test_reference_decode_serves_as_the_port_does(franky, width):
    """The controls' own decode, in float32: beams give the port's tokens
    and best-beam scores (EOS-aware, length penalty 1.0); top-k sampling
    draws from the same top k."""
    from frankenstein_tpu_torch.decode import sampling
    model, params, mc = franky
    x = torch.randn(3, 64, 16, generator=torch.Generator().manual_seed(6))
    traffic = {"max_new_tokens": 5, "beam_width": width, "top_k": 10}
    toks, scores = franky_ref.decode(x, params, mc, traffic,
                                     generator=torch.Generator())
    idx0 = torch.full((3, 1), franky_ref.EOT, dtype=torch.long)
    if width > 1:
        want, want_scores = sampling.beam_search(
            model, idx0, model.encode(x), max_new_tokens=5,
            beam_width=width, eos_id=franky_ref.EOT, length_penalty=1.0)
        assert torch.equal(toks, want)
        assert torch.allclose(scores, want_scores, atol=1e-5)
        return
    assert scores is None and toks.shape == (3, 5)
    logits = franky_ref.served_logits(x, toks, params, mc)
    tenth = torch.topk(logits, 10, dim=-1).values[..., -1]
    assert bool((torch.gather(logits, -1, toks[..., None])[..., 0]
                 >= tenth).all())
