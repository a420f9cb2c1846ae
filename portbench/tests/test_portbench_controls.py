"""The correctness check against its control and its faults, at a CPU size.

The control (the reference one step below the stated precision,
``reference/lowp.py``) must read worse than the program; each fault a cell
can have, planted under the timed path (``readings.plant``), must turn a
whole run's ``correct`` false. The same readings at the cells' own sizes
come from ``python3 -m portbench.readings`` on the card.
"""

import time

import pytest

from portbench import readings
from portbench import run as run_lib
from portbench.tests import tiny

SERVING = ["franky.submit-beam5-b32", "franky.offline-topk-b128"]
TRAINING = ["mae.pretrain-b256", "franky.train-b256"]


def _generator(spec):
    return run_lib.load_module(spec.root / "portbench" / "generators"
                               / f"{spec.traffic['generator']}.py")


@pytest.mark.parametrize("cell", SERVING)
def test_serving_control_reads_worse_than_the_program(cell):
    """The control serves the same windows itself and the run's own
    comparison finds it not correct, where the program is."""
    spec = tiny.spec(cell)
    got = readings.serve_readings(spec, _generator(spec), 21, 3, True, "cpu")
    assert got["program"]["correct"], got
    assert got["control"]["correct"] is False, got
    prog, ctrl = got["program"]["checks"], got["control"]["checks"]
    assert any(ctrl[k]["value"] > 3 * max(prog[k]["value"], 1e-3)
               for k in prog), got


@pytest.mark.parametrize("cell", TRAINING)
def test_training_control_reads_worse_than_the_program(cell):
    spec = tiny.spec(cell)
    got = readings.train_readings(spec, _generator(spec), 22, True, "cpu")
    prog, ctrl = got["program"]["gaps"], got["control"]["gaps"]
    worse = [k for k in ("loss_gap", "grad_gap", "change_gap")
             if ctrl[k][0] > 3 * prog[k][0]]
    assert worse, got


def _run(spec, seed=2 ** 31 + 99):
    out = run_lib.run_cell(spec, seed, 1.0, False, "cpu",
                           time.perf_counter())
    return run_lib.result_line(out, spec, {})


@pytest.mark.parametrize("cell,fault", [(c, f) for c in SERVING
                                        for f in ("token", "half")])
def test_a_serving_fault_turns_correct_false(cell, fault, monkeypatch):
    readings.plant(fault, "serve", monkeypatch.setattr)
    line = _run(tiny.spec(cell))
    assert line["correct"] is False, line["checks"]


def test_the_reorder_fault_moves_the_served_beams(monkeypatch):
    """The K3 fault (each sentence's first two beams' caches swapped) is
    planted under the beam search: the served scores move. At the cell's
    size it is read on the card (``portbench.readings --fault reorder``)."""
    spec = tiny.spec("franky.submit-beam5-b32")
    gen = _generator(spec)

    def scores():
        model, predict, _ = gen.build(spec, 5, "cpu")
        cap = gen.Capture(model)
        try:
            predict(gen.make_pool(spec, 5, "cpu")[0])
            return cap.served(1)[1][0]
        finally:
            cap.close()
    sound = scores()
    readings.plant("reorder", "serve", monkeypatch.setattr)
    assert abs(scores() - sound).max() > 1e-3


@pytest.mark.parametrize("cell", TRAINING)
def test_half_the_batch_left_out_turns_correct_false(cell, monkeypatch):
    readings.plant("half", "train", monkeypatch.setattr)
    line = _run(tiny.spec(cell))
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", TRAINING)
def test_a_step_that_keeps_its_state_turns_correct_false(cell, monkeypatch):
    from frankenstein_tpu_torch.train import trainer

    def unchanged(state, config, sched):
        state.step += 1
    monkeypatch.setattr(trainer, "apply_update", unchanged)
    line = _run(tiny.spec(cell))
    assert line["correct"] is False, line["checks"]
