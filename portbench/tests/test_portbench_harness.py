"""The harness as data: found by name, its result line, its refusals."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

from portbench import run as run_lib
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _checkout(tmp_path):
    """A copy of the benchmark's files (no tests, no caches)."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a generator and a metric added as new
    files and new entries run with no edit to an existing file."""
    root = _checkout(tmp_path)
    here = root / "portbench"
    (here / "configs" / "echo.json").write_text(json.dumps(
        {"name": "echo", "model": "none", "width": 7}))
    (here / "traffic" / "echo-mix.json").write_text(json.dumps(
        {"generator": "echo_load", "rate": 3}))
    (here / "generators" / "echo_load.py").write_text(textwrap.dedent("""
        def run(spec, seed, seconds, trace, device, t_start):
            width = spec.config["width"] * spec.traffic["rate"]
            return {"end_to_end": {"setup_s": 1.0, "ops_per_s": width},
                    "context": {"width": width}, "checks": {"x": (0, 1)},
                    "attempted": 1, "failed": 0,
                    "memory_peak_bytes": 0}
        """))
    (here / "metrics" / "echo_width.per.py").write_text(
        "def read(ctx):\n    return ctx['width'] + 0.5\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "echo", "source": "x",
                             "file": "portbench/configs/echo.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "echo.cell", "config": "echo",
                               "traffic": "echo-mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "ops_per_s", "unit": "ops/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["echo.cell"]})
    bench["per_layer"].append({"name": "echo_width.per", "unit": "ops",
                               "better": "higher", "source": "host_clock",
                               "layer": "echo", "moves": "ops_per_s",
                               "workloads": ["echo.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run_lib.load_spec(root, "echo.cell")
    assert spec.config["width"] == 7 and spec.traffic["rate"] == 3
    assert [m["name"] for m in spec.per_layer] == ["echo_width.per"]
    out = run_lib.run_cell(spec, 1, 1.0, False, "cpu", time.perf_counter())
    assert out["metrics"]["ops_per_s"]["value"] == 21
    assert set(out["metrics"]) == {"ops_per_s", "setup_s"}
    out = run_lib.run_cell(spec, 1, 1.0, True, "cpu", time.perf_counter())
    assert out["metrics"] == {"echo_width.per": {"value": 21.5,
                                                 "unit": "ops"}}


def test_result_line_has_its_keys_in_order_and_checks_last():
    out = {"checks": {"token_gap": (0.01, 0.1)}, "attempted": 3,
           "failed": 0, "metrics": {}, "breakdown": {"device_ops": []}}
    line = run_lib.result_line(out, None, {"platform": "gpu"})
    assert list(line)[:5] == KEYS
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    out["checks"]["token_gap"] = (0.2, 0.1)
    assert run_lib.result_line(out, None, {})["correct"] is False
    assert run_lib.result_line({**out, "checks": {}}, None,
                               {})["correct"] is False


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_tiny_run_has_each_cells_metrics(cell):
    """Each cell's traffic at a CPU size: correct, and the end-to-end
    metrics BENCHMARK.json gives it."""
    spec = tiny.spec(cell)
    out = run_lib.run_cell(spec, 2 ** 31 + 12345, 1.0, False, "cpu",
                           time.perf_counter())
    line = run_lib.result_line(out, spec, {})
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert line["attempted"] > 0


def test_banned_top_level_names_compare_whole():
    import types
    assert "frankenstein_tpu" not in run_lib.loaded_banned()
    sys.modules["jax"] = types.ModuleType("jax")
    try:
        assert run_lib.loaded_banned() == ["jax"]
    finally:
        del sys.modules["jax"]


def test_a_run_imports_no_jax_nor_the_jax_package(tmp_path):
    """A whole tiny run in a fresh process loads no module whose top-level
    name is jax, jaxlib, flax or frankenstein_tpu."""
    code = textwrap.dedent("""
        import sys, time
        from portbench import run
        from portbench.tests import tiny
        spec = tiny.spec("franky.submit-beam5-b32")
        run.run_cell(spec, 7, 0.5, True, "cpu", time.perf_counter())
        tops = {m.split(".")[0] for m in sys.modules}
        assert "frankenstein_tpu_torch" in tops
        print(run.loaded_banned())
        """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    got = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_a_run_exits_nonzero_and_prints_no_result():
    got = subprocess.run(
        [sys.executable, "-c",
         "import torch, sys; torch.cuda.is_available = lambda: False; "
         "from portbench import run; sys.exit(run.main(['--workload', "
         "'franky.submit-beam5-b32', '--seed', '1', '--seconds', '1']))"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
    assert "CUDA" in got.stderr


def test_benchmark_only_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/ a run
    exits non-zero with no result (here, for want of a card first)."""
    root = _checkout(tmp_path)
    got = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "franky.submit-beam5-b32", "--seed", "1", "--seconds", "1"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert got.returncode != 0
    assert got.stdout.strip() == ""
