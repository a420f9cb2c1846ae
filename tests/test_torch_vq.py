"""The port's VQ-VAE (``ops/conv.py``, ``ops/vq.py``, ``models/vq_brain.py``)
against the JAX package's on the CPU: the causal convs' causality and
lengths, SoundStream's loss, reconstruction, indices and EMA update through
``export_soundstream`` + ``load_strict`` (cosine and euclidean), the
straight-through gradient, ``_kmeans`` given the JAX package's initial
indices, the refresh's properties (its draws are the port's own),
perplexity and the masked L1 loss. float32 on both sides, inputs from
numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.models import vq_brain as jvq_brain
from frankenstein_tpu.models.import_reference import export_soundstream
from frankenstein_tpu.ops import conv as jconv
from frankenstein_tpu.ops import vq as jvq
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.models import vq_brain
from frankenstein_tpu_torch.models.weights import (init_soundstream_,
                                                   load_strict)
from frankenstein_tpu_torch.ops import vq
from frankenstein_tpu_torch.ops.conv import (CausalConv1d,
                                             CausalConvTranspose1d)

torch.set_num_threads(1)

TOL = 1e-5        # f32 on both sides, other summation orders
CODEBOOK_TOL = 1e-6   # one EMA update of unit-norm codes

GEOM = dict(n_electrodes=6, C=8, D=4, codebook_size=16)


def _cfgs(**kw):
    kw = {**GEOM, **kw}
    return jconfig.VQVAEConfig(**kw), tconfig.VQVAEConfig(**kw)


def _pair(seed=0, t=16, **kw):
    """(jax SoundStream, its variables (initted, perturbed), port model
    with the same weights via export_soundstream, x [2, t, C] with a
    padded tail)."""
    jcfg, tcfg = _cfgs(**kw)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, jcfg.n_electrodes)).astype(np.float32)
    x[1, t - 4:] = 0.0
    jmodel = jvq_brain.SoundStream(jcfg)
    v = jmodel.init({"params": jax.random.key(seed), "vq": jax.random.key(1)},
                    jnp.asarray(x), train=False)
    perturb = lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(
        np.float32)
    q = v["vq"]["quantizer"]
    v = {"params": jax.tree_util.tree_map(perturb, v["params"]),
         "vq": {"quantizer": {
             "codebook": perturb(np.asarray(q["codebook"])) * 20,
             "cluster_size": np.asarray(q["cluster_size"]) + rng.uniform(
                 0, 3, q["cluster_size"].shape).astype(np.float32),
             "initted": jnp.ones((), jnp.bool_)}}}
    model = load_strict(vq_brain.SoundStream(tcfg), export_soundstream(v))
    return jmodel, v, model, x


# ---- convs -------------------------------------------------------------


def test_causal_conv_is_causal():
    conv = CausalConv1d(3, 4, kernel_size=5)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 20, 3)).astype(np.float32))
    y1 = conv(x)
    x2 = x.clone()
    x2[0, 10:] = 99.0                 # perturb the future
    y2 = conv(x2)
    assert y1.shape == (1, 20, 4)
    torch.testing.assert_close(y1[0, :10], y2[0, :10], atol=1e-6, rtol=0)
    assert not torch.allclose(y1[0, 10:], y2[0, 10:])


def test_causal_conv_strided_length():
    conv = CausalConv1d(3, 4, kernel_size=4, stride=2)
    assert conv(torch.zeros(1, 16, 3)).shape == (1, 8, 4)


def test_causal_transpose_conv_length_and_causality():
    ct = CausalConvTranspose1d(3, 4, kernel_size=4, stride=2)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 8, 3)).astype(np.float32))
    y1 = ct(x)
    assert y1.shape == (1, 16, 4)
    x2 = x.clone()
    x2[0, 4:] = 7.0
    # output frames < 4 * stride depend only on inputs < 4
    torch.testing.assert_close(ct(x2)[0, :8], y1[0, :8], atol=1e-6, rtol=0)


@pytest.mark.parametrize("k,stride,dilation", [(5, 1, 1), (3, 1, 2),
                                               (4, 2, 1), (1, 1, 1)])
def test_causal_conv_matches_jax(k, stride, dilation):
    rng = np.random.default_rng(k + stride + dilation)
    x = rng.standard_normal((2, 16, 3)).astype(np.float32)
    jc = jconv.CausalConv1d(5, k, stride=stride, dilation=dilation)
    params = jc.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jc.apply(params, jnp.asarray(x)))
    conv = CausalConv1d(3, 5, k, stride=stride, dilation=dilation)
    p = params["params"]["Conv_0"]
    with torch.no_grad():            # flax [k, in, out] -> torch [out, in, k]
        conv.weight.copy_(torch.from_numpy(
            np.asarray(p["kernel"]).transpose(2, 1, 0).copy()))
        conv.bias.copy_(torch.from_numpy(np.asarray(p["bias"]) + 0.1))
    got = conv(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want + 0.1, atol=TOL)


@pytest.mark.parametrize("k,stride", [(4, 2), (6, 3), (2, 1)])
def test_causal_transpose_conv_matches_jax(k, stride):
    """The JAX kernel is the torch one flipped along its width
    (import_reference.py:_conv_transpose); the port computes torch's."""
    rng = np.random.default_rng(k * stride)
    x = rng.standard_normal((2, 8, 3)).astype(np.float32)
    jc = jconv.CausalConvTranspose1d(5, k, stride=stride)
    params = jc.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jc.apply(params, jnp.asarray(x)))
    ct = CausalConvTranspose1d(3, 5, k, stride=stride)
    kern = np.asarray(params["params"]["ConvTranspose_0"]["kernel"])
    with torch.no_grad():            # [k, in, out] flipped -> [in, out, k]
        ct.weight.copy_(torch.from_numpy(
            kern[::-1].transpose(1, 2, 0).copy()))
        ct.bias.zero_()
    got = ct(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 8 * stride, 5)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_conv_computes_in_its_dtype():
    conv = CausalConv1d(3, 4, 3, dtype=torch.bfloat16)
    y = conv(torch.randn(1, 8, 3))
    assert conv.weight.dtype == torch.float32 and y.dtype == torch.bfloat16


# ---- SoundStream against JAX ------------------------------------------


@pytest.mark.parametrize("cosine", [True, False])
def test_soundstream_eval_matches_jax(cosine):
    jmodel, v, model, x = _pair(use_cosine_sim=cosine)
    (want_loss, want_recon), aux = jmodel.apply(
        v, jnp.asarray(x), train=False, mutable=["aux"])
    with torch.no_grad():
        loss, recon = model(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL)
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(want_recon),
                               atol=TOL)
    for key in ("perplexity", "rec_loss", "commit_loss"):
        np.testing.assert_allclose(float(model.aux[key]),
                                   float(aux["aux"][key][0]), rtol=TOL)
    want_idx, want_q = jmodel.apply(
        v, jnp.asarray(x), method=jvq_brain.SoundStream.get_quantize_vectors)
    idx, quantized = model.get_quantize_vectors(torch.from_numpy(x))
    assert idx.shape == (2, 4) and quantized.shape == (2, 4, GEOM["D"])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(quantized.numpy(), np.asarray(want_q),
                               atol=TOL)


@pytest.mark.parametrize("cosine", [True, False])
def test_one_ema_update_matches_jax(cosine):
    """A train step with no dead code (threshold 0) and an initted
    codebook draws nothing: the updated codebook and cluster sizes are the
    JAX package's within 1e-6, and embed_avg = embed * cluster_size."""
    jmodel, v, model, x = _pair(use_cosine_sim=cosine,
                                threshold_ema_dead_code=0.0)
    (want_loss, want_recon), mutated = jmodel.apply(
        v, jnp.asarray(x), train=True, mutable=["vq", "aux"],
        rngs={"vq": jax.random.key(3)})
    loss, recon = model(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL)
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(want_recon),
                               atol=TOL)
    q = mutated["vq"]["quantizer"]
    book = model.quantizer._codebook
    assert not np.allclose(book.embed.numpy(),
                           v["vq"]["quantizer"]["codebook"])
    np.testing.assert_allclose(book.embed.numpy(), np.asarray(q["codebook"]),
                               atol=CODEBOOK_TOL)
    np.testing.assert_allclose(book.cluster_size.numpy(),
                               np.asarray(q["cluster_size"]), atol=1e-6)
    torch.testing.assert_close(book.embed_avg,
                               book.embed * book.cluster_size[:, None])
    assert float(book.initted) == 1.0


def test_straight_through_gradient_matches_jax():
    cfg_j, cfg_t = _cfgs(kmeans_init=False)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, cfg_j.D)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jv = jvq.VectorQuantize(cfg_j)
    variables = jv.init({"params": jax.random.key(0), "vq": jax.random.key(1)},
                        jnp.asarray(x), train=False)

    def f(xx):
        q, _, commit = jv.apply(variables, xx, train=False)
        return jnp.sum(q * w) + commit

    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    tv = vq.VectorQuantize(cfg_t)
    tv._codebook.embed.copy_(torch.from_numpy(
        np.array(variables["vq"]["codebook"])))
    xt = torch.from_numpy(x).requires_grad_()
    q, idx, commit = tv(xt, train=False)
    (torch.sum(q * torch.from_numpy(w)) + commit).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=TOL)
    # straight through: the quantized value is the code, the gradient
    # of sum(q * w) is w itself
    np.testing.assert_allclose(
        q.detach().numpy(),
        vq.l2norm(tv._codebook.embed)[idx].numpy(), atol=1e-6)


@pytest.mark.parametrize("cosine", [True, False])
def test_kmeans_with_jax_indices_matches_jax(cosine):
    rng = np.random.default_rng(4)
    samples = np.concatenate([rng.standard_normal((40, 4)) + 5,
                              rng.standard_normal((40, 4)) - 5,
                              rng.standard_normal((40, 4))]).astype(np.float32)
    key = jax.random.key(7)
    want_means, want_counts = jvq._kmeans(key, jnp.asarray(samples), 8, 10,
                                          cosine)
    init_idx = np.asarray(jax.random.randint(key, (8,), 0, len(samples)))
    means, counts = vq._kmeans(torch.from_numpy(samples), 8, 10, cosine,
                               torch.from_numpy(init_idx).long())
    np.testing.assert_allclose(means.numpy(), np.asarray(want_means),
                               atol=TOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))


def test_kmeans_init_from_the_first_train_batch():
    """initted 0 (kmeans_init): the first train forward runs k-means from
    the generator's draws and sets initted; the codes get used."""
    _, cfg = _cfgs(codebook_size=32, D=8)
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.standard_normal((50, 8)) + 10,
                        rng.standard_normal((50, 8)) - 10])[None]
    model = vq.VectorQuantize(cfg)
    assert not model.initted()
    gen = torch.Generator().manual_seed(0)
    _, idx, _ = model(torch.from_numpy(x.astype(np.float32)), train=True,
                      generator=gen)
    assert model.initted() and float(model._codebook.initted) == 1.0
    assert float(vq.codebook_perplexity(idx, cfg.codebook_size)) > 1.5
    # the draws are the generator's: the same seed gives the same codebook
    again = vq.VectorQuantize(cfg)
    again(torch.from_numpy(x.astype(np.float32)), train=True,
          generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again._codebook.embed, model._codebook.embed,
                               atol=0, rtol=0)


def test_initted_is_read_again_after_a_write():
    _, cfg = _cfgs()
    model = vq.VectorQuantize(cfg)
    assert not model.initted()
    model._codebook.initted.fill_(1.0)
    assert model.initted()
    model.load_state_dict({**model.state_dict(),
                           "_codebook.initted": torch.zeros(1)})
    assert not model.initted()


@pytest.mark.parametrize("cosine", [True, False])
def test_refresh_properties(cosine):
    """Each code under the threshold takes a row of the batch (l2norm of
    it, cosine) and cluster size 1; the others keep the EMA update."""
    _, cfg = _cfgs(use_cosine_sim=cosine, kmeans_init=False,
                   threshold_ema_dead_code=2.0)
    rng = np.random.default_rng(6)
    model = vq.VectorQuantize(cfg)
    book = model._codebook
    book.embed.copy_(torch.from_numpy(rng.standard_normal(
        book.embed.shape).astype(np.float32)))
    sizes = np.full(cfg.codebook_size, 10.0, np.float32)
    sizes[::2] = 0.5                        # every other code is dead
    book.cluster_size.copy_(torch.from_numpy(sizes))
    x = torch.from_numpy(rng.standard_normal((3, 5, cfg.D)).astype(
        np.float32))
    model(x, train=True, generator=torch.Generator().manual_seed(1))
    rows = x.reshape(-1, cfg.D)
    rows = vq.l2norm(rows) if cosine else rows
    new_sizes = book.cluster_size.numpy()
    dead = new_sizes == 1.0
    assert dead[::2].all()                  # 0.5 * 0.8 + counts * 0.2 < 2
    assert not dead[1::2].any()
    for code in np.flatnonzero(dead):
        dist = (rows - book.embed[code]).abs().amax(-1)
        assert float(dist.min()) < 1e-6, code
    torch.testing.assert_close(book.embed_avg,
                               book.embed * book.cluster_size[:, None])


def test_perplexity_matches_jax():
    rng = np.random.default_rng(7)
    for k in (1, 16, 1024):
        idx = rng.integers(0, k, (4, 48))
        want = float(jvq.codebook_perplexity(jnp.asarray(idx), k))
        got = float(vq.codebook_perplexity(torch.from_numpy(idx), k))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_masked_l1_ignores_padded_rows():
    gt = np.zeros((1, 4, 3), np.float32)
    gt[0, :2] = 1.0
    pred = np.zeros((1, 4, 3), np.float32)
    pred[0, 2:] = 100.0           # error only on padded rows: ignored
    loss = vq_brain.masked_l1_loss(torch.from_numpy(pred),
                                   torch.from_numpy(gt))
    np.testing.assert_allclose(float(loss), 1.0, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_l1_matches_jax(dtype):
    """Padded rows are found on gt as given, bf16 under mixed precision."""
    rng = np.random.default_rng(8)
    gt = rng.standard_normal((2, 6, 5)).astype(np.float32)
    gt[0, 4:] = 0.0
    gt[1, 1] = 0.0
    pred = rng.standard_normal(gt.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = float(jvq_brain.masked_l1_loss(jnp.asarray(pred, jdt),
                                          jnp.asarray(gt, jdt)))
    got = float(vq_brain.masked_l1_loss(torch.from_numpy(pred).to(dtype),
                                        torch.from_numpy(gt).to(dtype)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bf16_convs_and_an_f32_quantizer():
    """Under mixed precision the convs compute in bf16 on f32 parameters;
    the quantizer's codebook and loss stay f32."""
    _, cfg = _cfgs(kmeans_init=False)
    model = init_soundstream_(vq_brain.SoundStream(cfg, dtype=torch.bfloat16),
                              seed=0)
    x = torch.randn(2, 16, cfg.n_electrodes).to(torch.bfloat16)
    e = model.encoder(x)
    loss, recon = model(x, train=True, generator=torch.Generator())
    assert e.dtype == recon.dtype == torch.bfloat16
    assert loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.quantizer._codebook.embed.dtype == torch.float32
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_state_dict_is_the_exporters():
    """The port's names are the ones export_soundstream writes, at any
    number of strides (blocks at 2, 4, ..., last conv at 2n + 2)."""
    jmodel, v, model, _ = _pair()
    assert set(model.state_dict()) == set(export_soundstream(v))
    _, cfg = _cfgs(strides=(2, 2, 2))
    names = vq_brain.SoundStream(cfg).state_dict()
    assert "encoder.layers.6.layers.6.weight" in names
    assert "encoder.layers.8.weight" in names
    assert "decoder.layers.6.layers.0.weight" in names


def test_init_soundstream_scales():
    _, cfg = _cfgs(C=64, n_electrodes=32, D=16, codebook_size=256)
    model = init_soundstream_(vq_brain.SoundStream(cfg), seed=0)
    w = model.encoder.layers[0].weight          # [C, n_electrodes, 5]
    np.testing.assert_allclose(float(w.std()), 1 / np.sqrt(32 * 5), rtol=0.1)
    ct = model.decoder.layers[2].layers[0].weight   # [in, out, k]
    np.testing.assert_allclose(float(ct.std()), 1 / np.sqrt(64 * 4),
                               rtol=0.1)
    assert all(float(m.bias.abs().max()) == 0.0 for m in model.modules()
               if isinstance(m, torch.nn.Conv1d))
    book = model.quantizer._codebook
    np.testing.assert_allclose(float(book.embed.std()), 0.02, rtol=0.1)
    assert float(book.initted) == 0.0 and float(book.cluster_size.min()) == 1
    again = init_soundstream_(vq_brain.SoundStream(cfg), seed=0)
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), again.state_dict().values()))
