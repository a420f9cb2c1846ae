"""The day-1 dress rehearsal against the port: train -> checkpoint ->
decode -> sub.txt through the port's public CLIs
(``python -m frankenstein_tpu_torch.train`` and
``python -m frankenstein_tpu_torch.submit --run-dir``), in fresh processes
on the CPU, over a directory of synthetic .mat sessions laid out like
competitionData, with the tiny Franky of ``tests/test_dress_rehearsal.py``;
and the system's recipe's first step, MAE pretraining with that Franky's
encoder geometry, grafted into the Franky with ``--init-encoder-from``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

from tests.test_data import _write_synthetic_mat
from tests.test_dress_rehearsal import TINY_YAML

REPO = Path(__file__).resolve().parents[1]


def _run(args, timeout=300, rc=0):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert (p.returncode == 0) == (rc == 0), (
        f"{' '.join(args)} rc={p.returncode}\n--- stdout\n{p.stdout[-3000:]}"
        f"\n--- stderr\n{p.stderr[-3000:]}")
    return p


def test_train_then_submit_on_competition_layout(tmp_path):
    data = tmp_path / "competitionData"
    (data / "train").mkdir(parents=True)
    (data / "test").mkdir()
    _write_synthetic_mat(data / "train" / "t12.2022.04.28.mat", n_trials=6,
                         seed=41)
    _write_synthetic_mat(data / "train" / "t12.2022.05.05.mat", n_trials=5,
                         seed=42)
    _write_synthetic_mat(data / "test" / "t12.2022.05.18.mat", n_trials=4,
                         seed=43)
    cfg = tmp_path / "tiny_franky.yaml"
    cfg.write_text(TINY_YAML)
    logs = tmp_path / "logs"

    out = _run(["frankenstein_tpu_torch.train", "--config", str(cfg),
                "--data", str(data), "--exp-name", "dress",
                "--save-folder", str(logs), "--device", "cpu"])
    assert "done at step 3" in out.stdout

    run_dir = logs / "dress"
    doc = json.loads((run_dir / "model_config.json").read_text())
    assert doc["model"] == "franky"
    assert doc["model_config"]["gpt"]["n_embd"] == 16
    assert json.loads((run_dir / "train_config.json").read_text())[
        "max_steps"] == 3
    records = [json.loads(line) for line in
               (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train/loss" in r] == [1, 2, 3]
    assert [r["step"] for r in records if "val/loss" in r] == [2]
    ckpts = list(run_dir.glob("step_*_loss_*"))
    assert [c.name.split("_loss_")[0] for c in ckpts] == ["step_2"]
    assert (ckpts[0] / "state.pt").exists()

    sub = tmp_path / "sub.txt"
    _run(["frankenstein_tpu_torch.submit", "--data", str(data), "--split",
          "test", "--run-dir", str(run_dir), "--out", str(sub),
          "--beam-width", "2", "--batch-size", "4", "--device", "cpu"])
    assert len(sub.read_text().splitlines()) == 4   # one per held-out trial


def test_clis_need_a_gpu_unless_asked_for_the_cpu(tmp_path):
    """Without a usable GPU and without ``--device``, both CLIs exit
    non-zero and name ``--device cpu``; they never fall back on their own."""
    for args in (["frankenstein_tpu_torch.train", "--data", "synthetic",
                  "--steps", "1", "--save-folder", str(tmp_path)],
                 ["frankenstein_tpu_torch.submit", "--data", "synthetic",
                  "--checkpoint", str(tmp_path), "--out",
                  str(tmp_path / "sub.txt")]):
        p = _run(args, rc=1)
        assert "--device cpu" in p.stderr, p.stderr[-2000:]
    assert not (tmp_path / "sub.txt").exists()


def tiny_mae_yaml() -> str:
    """An MAE over TINY_YAML's encoder geometry (1024 tokens, 256 kept)."""
    lines = TINY_YAML.splitlines()
    enc = lines[lines.index("    encoder:") + 1:lines.index("    n_output_tokens: 4")]
    train = lines[lines.index("train:"):]
    return "\n".join(["model: mae", "model_config:",
                      *(line[4:] for line in enc), *train]) + "\n"


def test_mae_pretrains_then_grafts_into_franky(tmp_path):
    mae_cfg = tmp_path / "tiny_mae.yaml"
    mae_cfg.write_text(tiny_mae_yaml())
    franky_cfg = tmp_path / "tiny_franky.yaml"
    franky_cfg.write_text(TINY_YAML)
    logs = tmp_path / "logs"
    common = ["--data", "synthetic", "--synthetic-trials", "16",
              "--save-folder", str(logs), "--device", "cpu"]

    out = _run(["frankenstein_tpu_torch.train", "--config", str(mae_cfg),
                "--exp-name", "mae", *common])
    assert "done at step 3" in out.stdout
    doc = json.loads((logs / "mae" / "model_config.json").read_text())
    assert doc["model"] == "mae"
    assert doc["model_config"]["patch_size"] == 192
    records = [json.loads(line) for line in
               (logs / "mae" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "val/loss" in r] == [2]
    assert list((logs / "mae").glob("step_2_loss_*"))

    out = _run(["frankenstein_tpu_torch.train", "--config", str(franky_cfg),
                "--exp-name", "franky", "--init-encoder-from",
                str(logs / "mae"), *common])
    assert "done at step 3" in out.stdout
    bad = _run(["frankenstein_tpu_torch.train", "--config", str(mae_cfg),
                "--init-encoder-from", str(logs / "mae"), *common], rc=1)
    assert "--model franky, moe-gpt or franky-llama, not mae" in bad.stderr
