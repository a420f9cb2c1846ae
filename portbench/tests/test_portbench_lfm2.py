"""The FrankyLfm2 cell at a CPU size: the configuration file against the
catalog's shape, the float32 reference against the port's CPU path, the
new readers on a hand-built trace, the counts by hand, and tiny runs of
the cell with the control and a fault.
"""

import copy
import json
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from portbench import counts, counts_lfm2, readings, weights
from portbench import run as run_lib
from portbench.profile import CALL, Op, Trace
from portbench.reference import franky_lfm2 as ref
from portbench.tests import tiny

CELL = "franky-lfm2-8b.submit-beam5-b32-bf16"
LM = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 96,
      "moe_intermediate_size": 32, "num_hidden_layers": 4,
      "num_attention_heads": 4, "num_key_value_heads": 2,
      "layer_types": ["conv", "conv", "full_attention", "conv"],
      "conv_L_cache": 3, "conv_bias": False, "num_dense_layers": 1,
      "num_experts": 8, "num_experts_per_tok": 2, "use_expert_bias": True,
      "norm_topk_prob": True, "routed_scaling_factor": 1,
      "rope_theta": 1000000, "norm_eps": 1e-5,
      "max_position_embeddings": 128, "tie_word_embeddings": True}
BRAIN = dict(copy.deepcopy(tiny.FRANKY["model_config"]["brain"]),
             output_dim=64)
TINY = {"name": "tiny-lfm2", "model": "franky_lfm2",
        "model_config": {"brain": BRAIN, "lm": LM}}
CUT = {"batch": 4, "pool_batches": 2, "check_sentences": 8}


def spec(cell: str = CELL) -> run_lib.Spec:
    """The cell's spec with its configuration and traffic cut to the CPU."""
    real = run_lib.load_spec(tiny.ROOT, cell)
    return run_lib.Spec(real.root, cell, real.chips, copy.deepcopy(TINY),
                        dict(copy.deepcopy(real.traffic), **CUT),
                        real.end_to_end, real.per_layer)


def _generator(s):
    return run_lib.load_module(s.root / "portbench" / "generators"
                               / f"{s.traffic['generator']}.py")


def test_the_file_is_the_catalogs_lfm2_8b_a1b():
    """Every published key at the top level and as ``model_config.lm``,
    nothing reduced, the Perceiver at the LM's width, and the model the
    program builds from it holds 8.34B parameters."""
    from frankenstein_tpu_torch.config import FrankyLfm2Config
    from frankenstein_tpu_torch.models.franky import FrankyLfm2
    bench = tiny.bench()
    entry = next(c for c in bench["configs"] if c["name"] == "franky-lfm2-8b")
    cfg = json.loads((tiny.ROOT / entry["file"]).read_text())
    lm = cfg["model_config"]["lm"]
    published = {k: v for k, v in cfg.items() if k in lm}
    assert len(published) == 20 and entry["reduced"] == cfg["reduced"] == []
    assert all(lm[k] == v for k, v in published.items())
    assert cfg["model_config"]["brain"]["output_dim"] == lm["hidden_size"]
    model = FrankyLfm2(FrankyLfm2Config.from_dict(cfg["model_config"]),
                       device="meta")
    lm_params = sum(p.numel() for p in model.llm_model.parameters())
    assert 8.30e9 < lm_params < 8.40e9


def test_the_reference_imports_no_port_and_no_jax():
    code = textwrap.dedent("""
        import sys
        import portbench.reference.franky_lfm2
        print(sorted({m.split(".")[0] for m in sys.modules} & {
            "jax", "frankenstein_tpu", "frankenstein_tpu_torch"}))
        """)
    got = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip() == "[]"


def test_the_reference_matches_the_port_teacher_forced():
    from frankenstein_tpu_torch.config import FrankyLfm2Config
    from frankenstein_tpu_torch.models.franky import FrankyLfm2
    mc = copy.deepcopy(TINY["model_config"])
    model = FrankyLfm2(FrankyLfm2Config.from_dict(mc)).eval()
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    params = weights.make(shapes, ref.init_rule, 3, "cpu",
                          n_layer=ref.n_layer(mc))
    weights.load(model, params)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 16, generator=g)
    toks = torch.randint(0, 256, (2, 6), generator=g)
    with torch.no_grad():
        start = torch.full((2, 1), ref.EOT, dtype=torch.long)
        got = model.llm_model.logits(torch.cat([start, toks[:, :-1]], 1),
                                     model.encode(x))
    want = ref.served_logits(x, toks, params, mc, chunk=48)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_init_rule_draws_every_lm_kind():
    rule = lambda n, s=(8, 8): ref.init_rule(n, s, 24)
    pre = "llm_model.model.layers.3."
    assert rule(pre + "ffn_norm.weight") == (1.0, 0.05)
    assert rule(pre + "feed_forward.gate.weight") == (0.0, ref.ROUTER_STD)
    assert rule(pre + "feed_forward.expert_bias") == (0.0, ref.BIAS_STD)
    assert rule(pre + "conv.conv.weight", (8, 1, 3))[1] == pytest.approx(
        3 ** -0.5)
    assert rule(pre + "feed_forward.down_proj")[1] == pytest.approx(
        0.02 / 48 ** 0.5)
    assert rule(pre + "conv.in_proj.weight") == (0.0, 0.02)
    assert rule("brain_model.learnable_queries") == (0.0, 0.02)


def test_counts_by_hand():
    d, f, e, k = 64, 32, 8, 2
    # conv: in_proj, out_proj, taps; attention: q, k, v, o and 4 D a pair
    conv = 2 * d * 3 * d + 2 * d * d + 2 * 3 * d
    attn = 2 * d * d + 2 * 2 * d * 32 + 2 * d * d + 4 * 64 * 5
    dense = 2 * 3 * d * 96
    routed = 2 * d * e + k * 2 * 3 * d * f
    assert counts_lfm2.token_flops(LM, 5) == 3 * conv + attn + dense \
        + 3 * routed
    rows = 3
    used = e * (1 - (1 - 1 / e) ** (rows * k))
    want = max((used * 3 * d * f * 2 + rows * k * 2 * d * 2)
               / counts.HBM_BYTES_PER_S,
               rows * k * 6 * d * f / counts.PEAK_BF16_FLOPS)
    assert counts_lfm2.experts_bound(LM, rows) == pytest.approx(want)
    assert counts_lfm2.experts_bound(LM, rows, [1 / e] * e) == \
        pytest.approx(want)
    # at the beam cell's 160 rows every one of 32 experts is read
    big = dict(LM, num_experts=32, num_experts_per_tok=4)
    assert counts_lfm2.experts_bound(big, 160) == pytest.approx(
        (32 * 3 * d * f * 2 + 640 * 2 * d * 2) / counts.HBM_BYTES_PER_S,
        rel=1e-6)


def hand_built() -> dict:
    """Two requests, each with one ``decode.step``: per request a conv span
    launching 1 ms, a route, an experts span launching 2 ms and a combine
    launching 0.5 ms."""
    ops, spans = [], {CALL: [(0.0, 1.0), (1.0, 2.0)], "decode.step": []}
    for r in range(2):
        at = float(r)
        for name, t0, dur in (("lfm2.conv", 0.1, 1e-3),
                              ("moe.route", 0.2, 0.25e-3),
                              ("moe.experts", 0.3, 2e-3),
                              ("moe.combine", 0.4, 0.25e-3)):
            spans.setdefault(name, []).append((at + t0, at + t0 + 0.05))
            ops.append(Op(name, "other", at + t0 + 0.01, dur, at + t0 + 0.01))
        spans["decode.step"].append((at + 0.5, at + 0.6))
    trace = Trace(ops, spans, calls=2)
    tr = dict(spec().traffic)
    return {"kind": "serve", "config": copy.deepcopy(TINY), "traffic": tr,
            "window_s": 2.0, "requests": 2, "trace": trace}


def _reader(name):
    return run_lib.load_module(tiny.ROOT / "portbench" / "metrics"
                               / f"{name}.py").read


def test_the_span_readers_on_a_hand_built_trace():
    ctx = hand_built()
    assert _reader("experts_device_ms.lfm2")(ctx) == pytest.approx(2.0)
    assert _reader("route_device_ms.lfm2")(ctx) == pytest.approx(0.5)
    assert _reader("conv_device_ms.lfm2")(ctx) == pytest.approx(1.0)
    rows = 4 * 5
    bound = 3 * (counts_lfm2.experts_bound(LM, rows * 5)
                 + counts_lfm2.experts_bound(LM, rows))
    from frankenstein_tpu_torch.models import moe
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "expert_ends", {})
        assert _reader("experts_roofline.lfm2")(ctx) == pytest.approx(
            100.0 * bound / 2e-3)
        # measured shares: half the rows on expert 0, none on expert 7
        ends = torch.tensor([4, 5, 6, 7, 8, 8, 8, 8])
        mp.setattr(moe, "expert_ends", {i: ends for i in (1, 2, 3)})
        shares = torch.tensor([4, 1, 1, 1, 1, 0, 0, 0]) / 8
        skewed = 3 * (counts_lfm2.experts_bound(LM, rows * 5, shares)
                      + counts_lfm2.experts_bound(LM, rows, shares))
        assert skewed < bound
        assert _reader("experts_roofline.lfm2")(ctx) == pytest.approx(
            100.0 * skewed / 2e-3)
    flops = 2 * counts_lfm2.request_flops(TINY["model_config"], 4, rows, 25)
    assert _reader("mfu.lfm2")(ctx) == pytest.approx(
        100.0 * flops / (2.0 * counts.PEAK_BF16_FLOPS))
    for name in ("experts_device_ms.lfm2", "experts_roofline.lfm2",
                 "conv_device_ms.lfm2", "route_device_ms.lfm2"):
        assert _reader(name)({"kind": "serve"}) is None, name


def test_expert_load_reads_the_programs_counter(monkeypatch):
    from frankenstein_tpu_torch.models import moe
    # running sums of end offsets: rows [4, 4, 4, 4] and [8, 0, 4, 4]
    monkeypatch.setattr(moe, "expert_ends", {
        2: torch.tensor([4, 8, 12, 16]), 3: torch.tensor([8, 8, 12, 16])})
    assert _reader("expert_load.lfm2")({"kind": "serve"}) == \
        pytest.approx((1.0 + 2.0) / 2)
    monkeypatch.setattr(moe, "expert_ends", {})
    assert _reader("expert_load.lfm2")({"kind": "serve"}) is None


@pytest.mark.parametrize("cell", [CELL])
def test_a_tiny_run_is_correct_with_its_metrics(cell):
    s = spec(cell)
    out = run_lib.run_cell(s, 2 ** 31 + 4321, 0.5, False, "cpu",
                           time.perf_counter())
    line = run_lib.result_line(out, s, {})
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in s.end_to_end}
    out = run_lib.run_cell(s, 2 ** 31 + 4322, 0.5, True, "cpu",
                           time.perf_counter())
    # on the CPU no device operation runs: the share of a roofline over
    # 0 ms of device time reads nothing
    got = set(out["metrics"]) | {"experts_roofline.lfm2"}
    assert got == {m["name"] for m in s.per_layer}, got


def test_the_control_reads_worse_than_the_program():
    """At this size the tied head's logits spread about 0.2, so the control
    stays inside the cell's limits, which it fails at the cell's size on
    the card (``portbench.readings --control``); here it reads at least 3x
    the program."""
    s = spec()
    got = readings.serve_readings(s, _generator(s), 21, 3, True, "cpu")
    assert got["program"]["correct"], got
    prog, ctrl = got["program"]["checks"], got["control"]["checks"]
    assert any(ctrl[k]["value"] > 3 * max(prog[k]["value"], 1e-3)
               for k in prog), got


def test_the_token_fault_reads_far_above_the_program(monkeypatch):
    """One served token of every sentence altered: at this size the gap it
    reads is under the cell's limits, which it fails at the cell's size
    (``portbench.readings --fault token``), and 10x the program's."""
    s = spec()
    clean = readings.serve_readings(s, _generator(s), 23, 2, False, "cpu")
    readings.plant("token", "serve", monkeypatch.setattr)
    bad = readings.serve_readings(s, _generator(s), 23, 2, False, "cpu")
    gap = lambda got: got["program"]["checks"]["token_gap"]["value"]
    assert gap(bad) > 10 * max(gap(clean), 1e-3), (clean, bad)
