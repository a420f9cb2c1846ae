"""The readers of the program's spans (``metrics/_spans.py``) on a
hand-built trace, and each span metric read in a tiny traced run of its
cell on the CPU (where no device operation runs: the copy reads 0 ms and a
span is idle throughout)."""

import time

import pytest

from portbench import run as run_lib
from portbench.metrics import _spans
from portbench.profile import CALL, Op, Trace
from portbench.tests import tiny


def hand_built() -> dict:
    """Two calls over [0, 10] s; spans "x" at [1, 4] and [6, 9]; three
    operations: one launched in each span (the second running past the
    window), one launched between them."""
    ops = [Op("a", "other", 2.0, 1.0, 1.5), Op("b", "other", 5.0, 2.0, 4.5),
           Op("c", "other", 8.5, 2.0, 7.0)]
    return {"trace": Trace(ops, {CALL: [(0.0, 5.0), (5.0, 10.0)],
                                 "x": [(6.0, 9.0), (1.0, 4.0)]}, calls=2)}


def test_idle_is_the_spans_less_the_busy_time():
    # [1, 4] less [2, 3]: 2 s; [6, 9] less [5, 7] and [8.5, 10]: 1.5 s
    assert _spans.idle_ms(hand_built(), "x") == pytest.approx(1750.0)


def test_device_time_counts_what_the_spans_launched():
    assert _spans.device_ms(hand_built(), "x") == pytest.approx(1500.0)


def test_host_time_is_the_spans_length():
    assert _spans.host_ms(hand_built(), "x") == pytest.approx(3000.0)


@pytest.mark.parametrize("read", [_spans.idle_ms, _spans.device_ms,
                                  _spans.host_ms])
def test_no_span_or_no_trace_reads_nothing(read):
    assert read(hand_built(), "y") is None
    assert read({}, "x") is None


SPAN_METRICS = {
    "franky.offline-topk-b128": ["upload_device_ms.serve",
                                 "decode_idle_ms.serve"],
    "franky.submit-beam5-b32": ["upload_device_ms.beam",
                                "decode_idle_ms.beam"],
    "franky.train-b256": ["forward_idle_ms.finetune",
                          "backward_idle_ms.finetune",
                          "loader_wait_ms.finetune"],
}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_tiny_traced_run_reads_its_span_metrics(cell):
    spec = tiny.spec(cell)
    assert {m["name"] for m in spec.per_layer} >= set(SPAN_METRICS[cell])
    out = run_lib.run_cell(spec, 2 ** 31 + 99, 0.5, True, "cpu",
                           time.perf_counter())
    got = {k: v["value"] for k, v in out["metrics"].items()}
    for name in SPAN_METRICS[cell]:
        assert got[name] >= 0.0, name
    if cell.startswith("franky.train"):
        assert got["forward_idle_ms.finetune"] > 0.0
        assert got["backward_idle_ms.finetune"] > 0.0
    else:
        assert got[SPAN_METRICS[cell][0]] == 0.0     # no device copy
        assert got[SPAN_METRICS[cell][1]] > 0.0
