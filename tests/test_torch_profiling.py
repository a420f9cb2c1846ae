"""The port's ``utils/profiling.py`` against the JAX package's on the CPU:
every FLOP and byte formula equal to JAX's for the repo's configs, MFU and
parameter counts; the peaks are the H100's by name and None without a
card (the port carries no TPU figure); ``trace`` writes a Chrome trace;
``chip_smoke.py`` takes its rates from here."""

import json
from pathlib import Path

import pytest
import torch
import yaml

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.models import franky as jfranky
from frankenstein_tpu.utils import profiling as jprof
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


def _yaml(name):
    return yaml.safe_load((ROOT / "configs" / name).read_text())[
        "model_config"]


def _pairs():
    """(name, jax config, port config) for the configs each formula
    takes: the defaults and the repo's YAMLs."""
    fl = _yaml("franky_llama.yaml")
    return {
        "franky": [(jconfig.FrankyConfig(), tconfig.FrankyConfig()),
                   (jconfig.FrankyConfig.from_dict(_yaml("franky.yaml")),
                    tconfig.FrankyConfig.from_dict(_yaml("franky.yaml")))],
        "franky_llama": [(jfranky.FrankyLlamaConfig(),
                          tconfig.FrankyLlamaConfig()),
                         (jfranky.FrankyLlamaConfig.from_dict(fl),
                          tconfig.FrankyLlamaConfig.from_dict(fl))],
        "mae": [(jconfig.MAEConfig(), tconfig.MAEConfig()),
                (jconfig.MAEConfig.from_dict(_yaml("mae.yaml")),
                 tconfig.MAEConfig.from_dict(_yaml("mae.yaml")))],
        "vqvae": [(jconfig.VQVAEConfig(), tconfig.VQVAEConfig()),
                  (jconfig.VQVAEConfig.from_dict(_yaml("vqvae.yaml")),
                   tconfig.VQVAEConfig.from_dict(_yaml("vqvae.yaml"))),
                  (jconfig.VQVAEConfig(strides=(2, 3), C=64),
                   tconfig.VQVAEConfig(strides=(2, 3), C=64))],
    }


FORMULAS = [
    ("franky_encode_flops_per_sample", "franky", {}),
    ("franky_fwd_flops_per_sample", "franky", {}),
    ("franky_llama_fwd_flops_per_sample", "franky_llama", {}),
    ("mae_fwd_flops_per_sample", "mae", {}),
    ("vqvae_fwd_flops_per_sample", "vqvae", {}),
    ("vqvae_fwd_flops_per_sample", "vqvae", {"t": 1024}),
]


@pytest.mark.parametrize("fn,kind,kw", FORMULAS)
def test_model_formulas_match_jax(fn, kind, kw):
    for jcfg, tcfg in _pairs()[kind]:
        assert getattr(profiling, fn)(tcfg, **kw) == \
            getattr(jprof, fn)(jcfg, **kw)


def test_vqvae_flops_at_the_yaml():
    """6.304 GFLOP a sample forward at configs/vqvae.yaml's width."""
    cfg = tconfig.VQVAEConfig.from_dict(_yaml("vqvae.yaml"))
    assert abs(profiling.vqvae_fwd_flops_per_sample(cfg) / 1e9
               - 6.304038912) < 1e-9


@pytest.mark.parametrize("kw", [
    dict(seq=6144, dim=256, hidden=1024, n_heads=8, head_dim=32, n_layers=4),
    dict(seq=57, dim=768, hidden=3072, n_heads=12, head_dim=64, n_layers=12,
         n_mlp_mats=2),
    dict(seq=32, dim=256, hidden=512, n_heads=8, head_dim=32, n_layers=2,
         kv_seq=6144)])
def test_block_stack_matches_jax(kw):
    assert profiling.block_stack_fwd_flops(**kw) == \
        jprof.block_stack_fwd_flops(**kw)


def test_transformer_flops_per_token_matches_jax():
    args = (124_000_000, 12, 12, 64, 1024)
    assert profiling.transformer_flops_per_token(*args) == \
        jprof.transformer_flops_per_token(*args)


@pytest.mark.parametrize("kw", [
    {}, {"weight_bytes": 1, "lm_head_bytes": 2},
    {"cache_bytes": 1}, {"lm_head_every_step": False}])
def test_gpt_decode_bytes_match_jax(kw):
    for b, length, n in ((8, 57, 25), (160, 64, 1)):
        assert profiling.gpt_decode_hbm_bytes(
            tconfig.GPTConfig(), b, length, n, **kw) == \
            jprof.gpt_decode_hbm_bytes(jconfig.GPTConfig(), b, length, n, **kw)


def test_peaks_are_the_h100s_and_none_elsewhere():
    assert profiling.detect_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert profiling.detect_hbm_bw("NVIDIA H100 80GB HBM3") == 3.35e12
    assert profiling.detect_peak_flops("TPU v5 lite") is None
    assert profiling.detect_hbm_bw("some other card") is None
    if not torch.cuda.is_available():
        assert profiling.detect_peak_flops() is None
        assert profiling.detect_hbm_bw() is None
        assert profiling.estimate_mfu(1e12, 1.0) is None


def test_no_tpu_figure_in_the_port():
    text = Path(profiling.__file__).read_text()
    for figure in ("197e12", "275e12", "459e12", "918e12", "819e9",
                   "v5e", "v4", "v6e"):
        assert figure not in text


def test_estimate_mfu_matches_jax_with_a_peak():
    for args in ((3.6e15, 2.0, 989e12), (1e12, 0.5, 1e12)):
        assert profiling.estimate_mfu(*args) == jprof.estimate_mfu(
            *args, n_chips=1)


def test_count_parameters_of_a_module_and_a_state_dict():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    assert profiling.count_parameters(model) == 3 * 4 + 4 + 4 * 2 + 2
    assert profiling.count_parameters(model.state_dict()) == 26
    import numpy as np
    assert profiling.count_parameters({"a": torch.zeros(2, 3)}) == \
        jprof.count_parameters({"a": np.zeros((2, 3))})


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    doc = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])


def test_chip_smoke_takes_its_rates_from_profiling():
    import chip_smoke
    h100 = profiling.H100_SXM
    assert chip_smoke.BF16_OPS_PER_S == profiling.PEAK_FLOPS[h100]
    assert chip_smoke.HBM_BYTES_PER_S == profiling.HBM_BW[h100]
    assert chip_smoke.INT8_OPS_PER_S == profiling.PEAK_INT8_OPS[h100]
