"""The port's reference-checkpoint files (``models/import_reference.py``,
``convert_reference.py``) against the JAX package's on the CPU: files the
JAX ``save_state_dict`` writes read by the port's reader with the
``safetensors`` package blocked, and the port's files read by JAX's; the
dtypes and ``.pt`` wrappers; a reference SoundStream (``[1, K, D]``
codebook, no cluster sizes) loaded as the JAX ``soundstream_params``
reads it; a strict Franky load from a file giving JAX's logits; and the
converter CLI, whose checkpoints are the JAX importer's trees written back
by its exporters."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.models import import_reference as jir
from frankenstein_tpu.models import vq_brain as jvq_brain
from frankenstein_tpu.models.franky import Franky as JFranky
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch import convert_reference
from frankenstein_tpu_torch.models import import_reference as ir
from frankenstein_tpu_torch.models.franky import Franky
from frankenstein_tpu_torch.models.vq_brain import SoundStream
from frankenstein_tpu_torch.models.weights import load_strict
from frankenstein_tpu_torch.train import checkpoints as ckpt_lib
from tests.test_import_reference import (CFG, VCFG, ref_encoder_sd,
                                         ref_soundstream_sd)
from tests.test_torch_franky import tiny_cfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def no_safetensors(monkeypatch):
    """The card has no safetensors package: make every import of it fail."""
    for name in ("safetensors", "safetensors.numpy", "safetensors.torch"):
        monkeypatch.setitem(sys.modules, name, None)


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_reads_the_jax_writers_file(tmp_path, no_safetensors):
    sd = ref_encoder_sd(CFG, np.random.default_rng(0))
    jir_path = tmp_path / "ref.safetensors"
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401
    # the JAX writer needs the package: it writes in a process of its own
    np.savez(tmp_path / "sd.npz", **sd)
    subprocess.run([sys.executable, "-c", (
        "import numpy as np, sys; sys.path.insert(0, sys.argv[3]);"
        "from frankenstein_tpu.models import import_reference as ir;"
        "sd = dict(np.load(sys.argv[1]));"
        "ir.save_state_dict(sd, sys.argv[2])"),
        str(tmp_path / "sd.npz"), str(jir_path), str(ROOT)],
        check=True, timeout=300)
    got = ir.load_state_dict(jir_path)
    assert all(t.dtype == torch.float32 for t in got.values())
    _assert_same({k: v.numpy() for k, v in got.items()}, sd)


def test_the_jax_reader_reads_the_ports_file(tmp_path):
    sd = ref_encoder_sd(CFG, np.random.default_rng(1))
    ir.save_state_dict(sd, tmp_path / "port.safetensors")
    _assert_same(jir.load_state_dict(str(tmp_path / "port.safetensors")), sd)


def test_dtypes_both_ways(tmp_path):
    from safetensors.torch import load_file, save_file
    sd = {"f32": torch.randn(3, 4), "bf16": torch.randn(5).bfloat16(),
          "f16": torch.randn(2, 2).half(), "i64": torch.arange(7),
          "i32": torch.arange(3, dtype=torch.int32),
          "bool": torch.tensor([True, False]), "scalar": torch.tensor(1.5),
          "empty": torch.zeros(0, 3)}
    save_file(sd, tmp_path / "a.safetensors")
    got = ir.load_state_dict(tmp_path / "a.safetensors")
    ir.save_state_dict(sd, tmp_path / "b.safetensors")
    back = load_file(tmp_path / "b.safetensors")
    for name, want in sd.items():
        for t in (got[name], back[name]):
            assert t.dtype == want.dtype and t.shape == want.shape, name
            assert torch.equal(t, want), name
    # the header is padded to 8 bytes, as the safetensors writer pads it
    raw = (tmp_path / "b.safetensors").read_bytes()
    assert int.from_bytes(raw[:8], "little") % 8 == 0


@pytest.mark.parametrize("suffix,wrap", [(".pt", None), (".pth", "state_dict"),
                                         (".bin", "model")])
def test_torch_pickles_and_their_wrappers(tmp_path, suffix, wrap):
    sd = {k: torch.from_numpy(v) for k, v in
          ref_encoder_sd(CFG, np.random.default_rng(2)).items()}
    obj = sd if wrap is None else {wrap: sd, "epoch": 3}
    path = tmp_path / f"ckpt{suffix}"
    torch.save(obj, path)
    got = ir.load_state_dict(path)
    _assert_same({k: v.numpy() for k, v in got.items()},
                 jir.load_state_dict(str(path)))


@pytest.mark.parametrize("codebook_3d,cluster", [(True, True), (False, False)])
def test_reference_soundstream_loads_as_jax_reads_it(tmp_path, codebook_3d,
                                                     cluster):
    """A vector_quantize_pytorch state: the codebook as [1, K, D] (newer
    versions), with or without cluster sizes; the port's SoundStream gives
    the JAX model's loss and reconstruction on soundstream_params."""
    rng = np.random.default_rng(3)
    sd = ref_soundstream_sd(VCFG, rng)
    if codebook_3d:
        sd["quantizer._codebook.embed"] = sd["quantizer._codebook.embed"][None]
        sd["quantizer._codebook.cluster_size"] = \
            sd["quantizer._codebook.cluster_size"][None] + 0.5
    if not cluster:
        del sd["quantizer._codebook.cluster_size"]
    ir.save_state_dict(sd, tmp_path / "vq.safetensors")
    state = ir.soundstream_state(
        ir.load_state_dict(tmp_path / "vq.safetensors"))
    model = load_strict(SoundStream(tconfig.VQVAEConfig(**VCFG.to_dict())),
                        state)
    variables = jir.soundstream_params(sd)
    q = variables["vq"]["quantizer"]
    book = model.quantizer._codebook
    np.testing.assert_array_equal(book.embed.numpy(), q["codebook"])
    np.testing.assert_array_equal(book.cluster_size.numpy(),
                                  q["cluster_size"])
    assert model.quantizer.initted() and bool(q["initted"])
    torch.testing.assert_close(book.embed_avg,
                               book.embed * book.cluster_size[:, None])
    x = rng.normal(size=(2, 16, VCFG.n_electrodes)).astype(np.float32)
    (want_loss, want_recon), _ = jvq_brain.SoundStream(VCFG).apply(
        variables, jnp.asarray(x), mutable=["aux"])
    with torch.no_grad():
        loss, recon = model(torch.from_numpy(x))
    np.testing.assert_allclose(recon.numpy(), np.asarray(want_recon),
                               atol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


def test_soundstream_state_needs_a_codebook():
    with pytest.raises(ValueError, match="quantizer codebook"):
        ir.soundstream_state({"encoder.layers.0.weight": torch.zeros(1)})


def test_strict_franky_file_gives_jax_logits(tmp_path):
    rng = np.random.default_rng(4)
    jmodel = JFranky(tiny_cfg(jconfig))
    x = rng.standard_normal((2, 32, 8)).astype(np.float32)
    y = rng.integers(0, 512, (2, 8)).astype(np.int32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(x[:1]),
                         jnp.asarray(y[:1]))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    jir.save_state_dict(jir.export_franky(params),
                        str(tmp_path / "f.safetensors"))
    model = load_strict(Franky(tiny_cfg(tconfig)),
                        ir.load_state_dict(tmp_path / "f.safetensors"))
    _, want = jmodel.apply(params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        _, logits = model(torch.from_numpy(x), torch.from_numpy(y).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-3)
    with pytest.raises(KeyError, match="unexpected tensor"):
        load_strict(Franky(tiny_cfg(tconfig)),
                    {**ir.load_state_dict(tmp_path / "f.safetensors"),
                     "brain_model.extra": torch.zeros(1)})


def _random_state(model, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen) for k, v in
            model.state_dict().items() if not k.endswith("date_embedding")}


# the JAX importer and exporter of each kind the CLI converts here
JAX_KINDS = {
    "encoder": (jir.encoder_params, jir.export_encoder),
    "mae": (jir.mae_params, jir.export_mae),
    "brain_encoder": (jir.brain_encoder_params,
                      lambda p: jir.export_brain_encoder(p, head="to_motion")),
    "simple_mae": (lambda sd, **kw: jir.simple_mae_params(sd),
                   jir.export_simple_mae),
    "soundstream": (lambda sd, **kw: jir.soundstream_params(sd),
                    jir.export_soundstream),
}


@pytest.mark.parametrize("kind", sorted(JAX_KINDS))
def test_converter_cli_round_trip(tmp_path, kind):
    """A random reference file of each kind at its default geometry
    (BrainFormer's ``to_motion`` head for brain_encoder): the checkpoint
    holds the JAX importer's tree as its exporter writes it, and
    ``--reverse`` writes the file back bitwise."""
    _, _, module = convert_reference.build(
        kind, {"perceiver.to_motion.weight": None})
    sd = _random_state(module, seed=5)
    if kind == "soundstream":          # a trained codebook: sizes > 0
        sd["quantizer._codebook.cluster_size"] = \
            sd["quantizer._codebook.cluster_size"].abs() + 1
        sd["quantizer._codebook.initted"] = torch.ones(1)
        sd["quantizer._codebook.embed_avg"] = (
            sd["quantizer._codebook.embed"]
            * sd["quantizer._codebook.cluster_size"][:, None])
    src = tmp_path / "ref.safetensors"
    ir.save_state_dict(sd, src)
    ckpt = convert_reference.main(["--kind", kind, "--src", str(src),
                                   "--dst", str(tmp_path / "run")])
    assert ckpt.parent == tmp_path / "run" and ckpt.name == "step_0_loss_nan"
    got = ckpt_lib.load_raw_checkpoint(tmp_path / "run")["model"]
    importer, exporter = JAX_KINDS[kind]
    want = exporter(importer({k: v.numpy() for k, v in sd.items()}))
    _assert_same({k: v.numpy() for k, v in got.items()}, want)

    convert_reference.main(["--kind", kind, "--reverse", "--src",
                            str(tmp_path / "run"), "--dst",
                            str(tmp_path / "back.safetensors")])
    back = ir.load_state_dict(tmp_path / "back.safetensors")
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_converter_adds_zero_session_rows(tmp_path):
    _, _, module = convert_reference.build("encoder")
    sd = _random_state(module, seed=6)
    ir.save_state_dict(sd, tmp_path / "enc.safetensors")
    ckpt = convert_reference.main(["--kind", "encoder", "--src",
                                   str(tmp_path / "enc.safetensors"),
                                   "--dst", str(tmp_path / "run"),
                                   "--n-sessions", "3"])
    got = ckpt_lib.load_raw_checkpoint(ckpt)["model"]
    want = jir.encoder_params({k: v.numpy() for k, v in sd.items()},
                              n_sessions=3)["params"]["date_embedding"]
    np.testing.assert_array_equal(got["date_embedding"].numpy(), want)
    assert (tmp_path / "run" / "model_config.json").exists()


def test_converter_runs_as_a_module(tmp_path):
    _, cfg, module = convert_reference.build("soundstream")
    assert cfg == tconfig.VQVAEConfig()
    sd = _random_state(module, seed=7)
    del sd["quantizer._codebook.embed_avg"], sd["quantizer._codebook.initted"]
    ir.save_state_dict(sd, tmp_path / "vq.safetensors")
    p = subprocess.run(
        [sys.executable, "-m", "frankenstein_tpu_torch.convert_reference",
         "--kind", "soundstream", "--src", str(tmp_path / "vq.safetensors"),
         "--dst", str(tmp_path / "run")], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "imported soundstream" in p.stdout
    state = ckpt_lib.load_raw_checkpoint(tmp_path / "run")["model"]
    assert float(state["quantizer._codebook.initted"]) == 1.0
