"""The port's trace spans (``utils/profiling.py:span``) on the CPU: a shared
no-op with no profiler recording; under one, the span tree of a Franky
predictor call, of each decode loop, of a training step at
``grad_accum=2`` (the MAE and Franky) and of the loader's consumer, read
from the exported Chrome trace as the benchmark reads it. Spans change no
result."""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.data.loader import prefetch
from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
from frankenstein_tpu_torch.decode import pipeline, sampling
from frankenstein_tpu_torch.models.brainformer import MAE
from frankenstein_tpu_torch.models.franky import Franky
from frankenstein_tpu_torch.models.weights import init_franky_, init_mae_
from frankenstein_tpu_torch.train import trainer
from frankenstein_tpu_torch.utils import profiling

torch.set_num_threads(1)

B, N_STEPS, EOT = 3, 5, 511


def tiny_cfg():
    return tconfig.FrankyConfig(
        brain=tconfig.PerceiverConfig(
            encoder=tconfig.MAEConfig(window_size=32, n_electrodes=8,
                                      patch_size=8, dim=16, n_layers=1,
                                      head_dim=8, hidden_dim=32, n_heads=2,
                                      n_kv_heads=2, n_dec_layers=1,
                                      decoder_dim=16),
            n_output_tokens=4, output_dim=128, dim=16, n_layers=1,
            head_dim=8, hidden_dim=32, n_heads=2, n_kv_heads=2),
        gpt=tconfig.GPTConfig(block_size=64, vocab_size=512, n_layer=2,
                              n_head=4, n_embd=128),
        max_tokens=8, pad_token_id=EOT)


@pytest.fixture(scope="module")
def franky():
    return init_franky_(Franky(tiny_cfg()), seed=0).eval()


def windows(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, 32, 8)).astype(np.float32)


OURS = ("predict", "decode", "train", "loader", "outer", "inner",
        "consumer")


def traced(fn, tmp_path):
    """(fn's result, the port's and the test's spans as (name, start, end,
    thread) in start order) from a CPU profiler's Chrome trace; torch's
    own (the optimizer's) are left out."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
             for e in events if e.get("cat") == "user_annotation"
             and e["name"].split(".")[0] in OURS]
    return out, sorted(spans, key=lambda s: s[1])


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def holding(spans, parent, name):
    """The spans called ``name`` inside ``parent``."""
    return [s for s in named(spans, name) if inside(s, parent)]


def count(spans) -> Counter:
    return Counter(s[0] for s in spans)


def assert_steps(spans, n_steps, parts):
    """``n_steps`` decode.step spans, each holding one span of each name in
    ``parts`` and nothing else of the loop."""
    steps = named(spans, "decode.step")
    assert len(steps) == n_steps
    for step in steps:
        for part in ("decode.select", "decode.forward", "decode.reorder"):
            assert len(holding(spans, step, part)) == (part in parts), part


def test_span_is_one_shared_noop_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")

    monkeypatch.setattr(profiling, "record_function", refuse)
    first = profiling.span("predict")
    assert first is profiling.span("train.step") is profiling._NO_SPAN
    with first:
        pass


def test_span_is_a_record_function_under_a_profiler(tmp_path):
    def body():
        span = profiling.span("outer")
        assert span is not profiling._NO_SPAN
        with span:
            with profiling.span("inner"):
                torch.ones(4) + 1

    _, spans = traced(body, tmp_path)
    assert [s[0] for s in spans] == ["outer", "inner"]
    assert inside(spans[1], spans[0])


@pytest.mark.parametrize("kw", [{"top_k": 10}, {"beam_width": 3}],
                         ids=["topk", "beams"])
def test_predictor_span_tree(franky, kw, tmp_path):
    x = windows()
    opts = dict(max_new_tokens=N_STEPS, eot_id=EOT, seed=3, **kw)
    plain = pipeline.make_franky_predictor(franky, ByteTokenizer(), **opts)
    spanned = pipeline.make_franky_predictor(franky, ByteTokenizer(),
                                             **opts)
    want = plain(x)
    got, spans = traced(lambda: spanned(x), tmp_path)
    assert got == want
    beams = "beam_width" in kw
    expect = {"predict": 1, "predict.upload": 1, "predict.encode": 1,
              "predict.decode": 1, "predict.detokenize": 1,
              "decode.prefill": 1, "decode.step": N_STEPS,
              "decode.select": N_STEPS, "decode.forward": N_STEPS}
    if beams:
        expect.update({"decode.reorder": N_STEPS, "decode.rank": 1})
    assert count(spans) == expect
    (top,) = named(spans, "predict")
    assert all(inside(s, top) for s in spans)
    assert {s[3] for s in spans} == {top[3]}
    order = [s[0] for s in spans if s[0].startswith("predict.")]
    assert order == ["predict.upload", "predict.encode", "predict.decode",
                     "predict.detokenize"]
    (dec,) = named(spans, "predict.decode")
    for name in ("decode.prefill", "decode.step", "decode.rank"):
        assert all(inside(s, dec) for s in named(spans, name))
    parts = ("decode.select", "decode.forward") + (
        ("decode.reorder",) if beams else ())
    assert_steps(spans, N_STEPS, parts)


def _prompt(model):
    """The start tokens and the encoded windows."""
    return (torch.full((B, 1), EOT, dtype=torch.long),
            model.encode(torch.from_numpy(windows())))


@pytest.mark.parametrize("loop", ["greedy", "compact_topk", "sampled_beams",
                                  "greedy_from_prefill"])
def test_every_decode_loop_spans_its_steps(franky, loop, monkeypatch,
                                           tmp_path):
    """Each token loop of ``sampling.py`` gives one decode.step a token,
    holding its pick and the model's step (and, with beams, the reorder),
    and returns what it returns untraced."""
    gen = lambda: torch.Generator().manual_seed(0)
    idx0, prefix = _prompt(franky)
    steps, parts = N_STEPS, ("decode.select", "decode.forward")
    if loop == "greedy":
        run = lambda: sampling.generate(franky, idx0, prefix,
                                        max_new_tokens=N_STEPS, greedy=True)
    elif loop == "compact_topk":
        monkeypatch.setattr(sampling, "COMPACT_TOPK", True)
        run = lambda: sampling.generate(franky, idx0, prefix, gen(),
                                        max_new_tokens=N_STEPS, top_k=5)
    elif loop == "sampled_beams":
        parts += ("decode.reorder",)
        run = lambda: sampling.sampled_beam_search(
            franky, idx0, prefix, gen(), max_new_tokens=N_STEPS,
            beam_width=2, topk=4, eos_id=EOT)[0]
    else:
        steps = N_STEPS - 1

        def run():
            logits, cache, length = sampling._prefill(
                franky, idx0, prefix, N_STEPS, int8_kv=False)
            return sampling.greedy_decode_scan(franky, logits, cache, length,
                                               max_new_tokens=N_STEPS)
    want = run()
    got, spans = traced(run, tmp_path)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert len(named(spans, "decode.prefill")) == 1
    assert_steps(spans, steps, parts)
    assert len(named(spans, "decode.rank")) == (loop == "sampled_beams")


def _train_state(kind):
    if kind == "mae":
        model = init_mae_(MAE(tiny_cfg().brain.encoder), seed=0)
    else:
        model = init_franky_(Franky(tiny_cfg()), seed=0)
    cfg = tconfig.TrainConfig(batch_size=4, grad_accum=2, warmup_iters=0,
                              use_scheduler=False, mixed_precision=False)
    opt, sched = trainer.make_optimizer(cfg, model)
    return trainer.TrainState(model, opt), cfg, sched


@pytest.mark.parametrize("kind", ["mae", "franky"])
def test_train_step_span_tree(kind, tmp_path):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 32, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 256, (4, 8)))
    results = []
    for trace in (False, True):
        state, cfg, sched = _train_state(kind)
        step = lambda: trainer.train_step(state, (x, y), cfg, sched,
                                          torch.Generator())
        if trace:
            (loss, _), spans = traced(step, tmp_path)
        else:
            loss, _ = step()
        results.append((float(loss), [p.detach().clone()
                                      for p in state.model.parameters()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert count(spans) == {"train.step": 1, "train.prepare": 1,
                            "train.forward": 2, "train.backward": 2,
                            "train.update": 1}
    (top,) = named(spans, "train.step")
    assert all(inside(s, top) for s in spans)
    assert {s[3] for s in spans} == {top[3]}
    order = [s[0] for s in spans[1:]]
    assert order == ["train.prepare", "train.forward", "train.backward",
                     "train.forward", "train.backward", "train.update"]


def test_loader_wait_is_on_the_consumer_thread_only(tmp_path):
    def consume():
        with profiling.span("consumer"):
            return list(prefetch(iter(range(4))))

    got, spans = traced(consume, tmp_path)
    assert got == [0, 1, 2, 3]
    (consumer,) = named(spans, "consumer")
    waits = named(spans, "loader.wait")
    assert len(waits) == 5          # four batches, then the end
    assert {s[0] for s in spans} == {"consumer", "loader.wait"}
    assert all(inside(s, consumer) and s[3] == consumer[3] for s in waits)
