"""The port imports torch and numpy, never jax or the JAX package: every
module of ``frankenstein_tpu_torch`` (and ``chip_smoke.py``) imports in a
subprocess where ``import jax`` and ``import frankenstein_tpu`` fail."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["frankenstein_tpu"] = None
import frankenstein_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "frankenstein_tpu" or m.startswith("frankenstein_tpu.")]
assert not [m for m in loaded if sys.modules[m] is not None], loaded
print(len(names))
"""


def test_port_never_imports_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 15


def test_port_sources_never_name_jax():
    for path in (ROOT / "frankenstein_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax",
                                            "import frankenstein_tpu.",
                                            "from frankenstein_tpu.",
                                            "from frankenstein_tpu ")), \
                f"{path}: {line}"


_ALONE = r"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["frankenstein_tpu"] = None
mod = importlib.import_module(sys.argv[1])
print(",".join(n for n in sys.argv[2:] if hasattr(mod, n)))
"""


@pytest.mark.parametrize("name,attrs", [
    ("models.simple_mae", ["SimpleEncoder", "SimpleMAE"]),
    ("models.gpt2_import", ["config_for", "params_from_hf_state_dict",
                            "params_from_hf_model"]),
    ("models.brainformer", ["BrainFormer"]),
    ("models.weights", ["init_simple_mae_", "init_brainformer_",
                        "date_embedding_state", "init_whisper_",
                        "whisper_state_from_flax"]),
    ("models.whisper", ["BrainWhisper", "WhisperQuantCache",
                        "quantize_whisper_cache", "init_whisper_cache",
                        "params_from_hf_whisper", "sinusoids"]),
    ("ops.preprocess", ["zscore", "zscore_by_segments", "gaussian_kernel1d",
                        "gaussian_smooth", "resample_fft", "pca_fit",
                        "pca_transform"]),
    ("data.whisper_prep", ["fit_pca", "prepare_brain_data_for_whisper"]),
    ("eval.evaluate", ["evaluate_seq2seq_wer"]),
    ("decode.sampling", ["greedy_decode_scan"]),
    ("whisper_pipeline", ["build", "main", "tokenize_labels"]),
    ("ops.conv", ["CausalConv1d", "CausalConvTranspose1d"]),
    ("ops.vq", ["l2norm", "VectorQuantize", "codebook_perplexity"]),
    ("models.vq_brain", ["SoundStream", "masked_l1_loss"]),
    ("models.import_reference", ["load_state_dict", "save_state_dict",
                                 "soundstream_state"]),
    ("convert_reference", ["build", "main"]),
    ("decode.streaming", ["sliding_windows", "stream_predict"]),
    ("analysis", ["dataset_stats", "reduce_dimensionality",
                  "crop_gpt_layers", "crop_block_size"]),
    ("utils.profiling", ["detect_peak_flops", "estimate_mfu", "trace"]),
    ("utils.debugging", ["assert_finite_tree", "jit_eager_parity",
                         "enable_nan_debugging"]),
    ("models.moe", ["MoESwiGLU", "stable_topk", "shard_experts"]),
    ("parallel.mesh", ["maybe_initialize_distributed", "make_mesh",
                       "shard_batch", "replicate", "batch_shard",
                       "copy_to_group", "reduce_from_group",
                       "gather_from_group", "sum_grads"]),
    ("parallel.sharding", ["LLAMA_TP_RULES", "GPT2_TP_RULES",
                           "MOE_EP_RULES", "spec_for", "fsdp_spec",
                           "shard_params", "shard_params_fsdp",
                           "full_state", "local_optimizer_state"]),
    ("parallel.ring_attention", ["RingAttention", "ring_attention",
                                 "ring_attention_sharded", "seq_group"]),
    ("parallel.pipeline", ["gpipe", "pipelined_apply", "stage_scan",
                           "stage_params"]),
    ("dryrun", ["dryrun", "main"]),
    ("train.trainer", ["setup_parallel", "Parallel"]),
    ("models.weights", ["gpt_state_from_flax"])])
def test_new_modules_import_alone_without_jax(name, attrs):
    """Each module of the encoder-family training paths, of the whisper
    path, of the VQ-VAE slice and of the parallel modes and MoE imports by
    itself in a process where jax and the JAX package cannot load."""
    proc = subprocess.run(
        [sys.executable, "-c", _ALONE, f"frankenstein_tpu_torch.{name}",
         *attrs], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().split(",") == attrs
