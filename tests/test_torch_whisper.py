"""The port's BrainWhisper against the JAX package's, on the CPU, at
``tests/test_whisper.py:tiny_cfg()``'s geometry: the JAX module's flax
weights carried across by ``whisper_state_from_flax``, inputs from numpy
seeds. f32 unless a test says bf16.

Covered: the config copy; the encoder, full-sequence logits and the seq2seq
loss with -100 labels (and its gradients); cached prefill and steps against
the full decode; the dtypes under bf16 compute; ``quantize_whisper_cache``'s
codes (bitwise) and scales, and int8 decode logits; ``expand_cache`` and the
grouped cross attention; ``greedy_decode_scan``; ``beam_from_prefill`` over
float and int8 caches at length penalties 1 and 0; the w8a16 refusal; the
seeded initial weights; and the findings in the JAX whisper path that the
port reproduces (``ROADMAP.md`` §3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenstein_tpu import config as jconfig
from frankenstein_tpu.decode import sampling as jsampling
from frankenstein_tpu.models import whisper as jwhisper
from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.decode import sampling
from frankenstein_tpu_torch.models import whisper
from frankenstein_tpu_torch.models.weights import (init_whisper_,
                                                   load_strict,
                                                   whisper_state_from_flax)

torch.set_num_threads(1)

TOL = 1e-5         # f32 on both sides, other summation orders
LOGIT_TOL = 1e-4   # f32 logits through 2 + 2 layers and the tied head
CACHE_TOL = 1e-5   # cached vs full decode, the JAX test's tolerance
SCORE_TOL = 1e-5   # beam scores: sums of f32 log-probs
INT8_TOL = 1e-4    # int8 decode logits: the same codes, f32 dequantization

# tests/test_whisper.py:tiny_cfg()
TINY = dict(n_mels=8, n_audio_ctx=16, n_audio_state=16, n_audio_head=2,
            n_audio_layer=2, n_vocab=64, n_text_ctx=16, n_text_state=16,
            n_text_head=2, n_text_layer=2)
FRAMES = 2 * TINY["n_audio_ctx"]
JAX_CALLS = {}     # the pair's jitted JAX methods, by name


def _jit(jm, method=None):
    """``jm.apply`` with ``method``, jitted (eager flax runs op by op)."""
    return jax.jit(lambda p, *a, **kw: jm.apply(p, *a, method=method, **kw))


@pytest.fixture(scope="module")
def pair():
    """(JAX module, its params, the port's module with the same weights)."""
    jm = jwhisper.BrainWhisper(jconfig.WhisperConfig(**TINY))
    params = jax.jit(jm.init)(jax.random.key(0),
                              jnp.zeros((2, TINY["n_mels"], FRAMES)),
                              jnp.zeros((2, 6), jnp.int32))
    JAX_CALLS.update(
        call=_jit(jm), encode=_jit(jm, jwhisper.BrainWhisper.encode),
        prefill=_jit(jm, jwhisper.BrainWhisper.prefill),
        step=_jit(jm, jwhisper.BrainWhisper.decode_step))
    state = whisper_state_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           params))
    tm = load_strict(whisper.BrainWhisper(tconfig.WhisperConfig(**TINY)),
                     state)
    return jm, params, tm


def _mel(b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, TINY["n_mels"], FRAMES)).astype(np.float32)


def _prefill_both(pair, mel, max_new, prompt=None):
    """Both models prefilled from the same prompt: ((logits, cache,
    length) of JAX, the port's, the prompt)."""
    jm, params, tm = pair
    prompt = prompt or jm.sot_prompt()
    b = mel.shape[0]
    s = len(prompt) + max_new + 2
    j = JAX_CALLS["prefill"](
        params, jnp.tile(jnp.asarray(prompt, jnp.int32)[None], (b, 1)),
        jnp.asarray(mel), jwhisper.init_whisper_cache(jm.cfg, b, s))
    t = tm.prefill(torch.tensor(prompt).repeat(b, 1), torch.from_numpy(mel),
                   whisper.init_whisper_cache(tm.cfg, b, s))
    return j, t, prompt


def test_config_is_the_jax_config():
    jf = [(f.name, str(f.type)) for f in
          dataclasses.fields(jconfig.WhisperConfig)]
    tf = [(f.name, str(f.type)) for f in
          dataclasses.fields(tconfig.WhisperConfig)]
    assert tf == jf
    assert (dataclasses.asdict(tconfig.WhisperConfig())
            == dataclasses.asdict(jconfig.WhisperConfig()))
    cfg = tconfig.WhisperConfig(**TINY, sot_sequence=(61, 5, 7))
    assert tconfig.WhisperConfig.from_json(cfg.to_json()) == cfg


def test_parameter_names_are_hf_and_the_head_is_tied(pair):
    tm = pair[2]
    names = set(tm.state_dict())
    for name in ("model.encoder.conv1.weight",
                 "model.encoder.layers.1.self_attn.q_proj.bias",
                 "model.decoder.layers.0.encoder_attn.out_proj.weight",
                 "model.decoder.layer_norm.weight", "proj_out.weight"):
        assert name in names
    assert "model.encoder.layers.0.self_attn.k_proj.bias" not in names
    assert "model.encoder.positions" not in names        # non-persistent
    assert tm.proj_out.weight is tm.model["decoder"].embed_tokens.weight
    np.testing.assert_array_equal(
        tm.model["encoder"].positions.numpy(),
        np.asarray(jwhisper.sinusoids(TINY["n_audio_ctx"],
                                      TINY["n_audio_state"])))


def test_encode_matches_jax(pair):
    jm, params, tm = pair
    mel = _mel(2, 0)
    want = JAX_CALLS["encode"](params, jnp.asarray(mel))
    got = tm.encode(torch.from_numpy(mel))
    assert got.shape == (2, TINY["n_audio_ctx"], TINY["n_audio_state"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL)


def test_logits_and_loss_with_ignored_labels_match_jax(pair):
    """The shift-right behind the start token, -100 read as the pad id in
    the decoder's inputs and ignored by the loss."""
    jm, params, tm = pair
    mel = _mel(2, 1)
    labels = np.random.default_rng(1).integers(0, TINY["n_vocab"], (2, 6))
    labels[:, 4:] = -100
    labels[1, 2:] = -100
    jloss, jlogits = JAX_CALLS["call"](params, jnp.asarray(mel),
                                       jnp.asarray(labels))
    loss, logits = tm(torch.from_numpy(mel), torch.from_numpy(labels))
    assert logits.shape == (2, 6, TINY["n_vocab"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    # explicit decoder inputs, no labels
    ids = np.random.default_rng(2).integers(0, TINY["n_vocab"], (2, 5))
    _, jl = JAX_CALLS["call"](params, jnp.asarray(mel),
                              decoder_input_ids=jnp.asarray(ids))
    none, tl = tm(torch.from_numpy(mel), decoder_input_ids=torch.from_numpy(
        ids))
    assert none is None
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=LOGIT_TOL)


def test_gradients_match_jax(pair):
    """Every parameter's gradient of the seq2seq loss, the tied embedding
    (token table and head) included."""
    jm, params, tm = pair
    mel = _mel(2, 3)
    labels = np.random.default_rng(3).integers(0, TINY["n_vocab"], (2, 6))
    labels[:, 5:] = -100
    jgrads = jax.jit(jax.grad(lambda p: jm.apply(
        p, jnp.asarray(mel), jnp.asarray(labels))[0]))(params)
    want = whisper_state_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          jgrads))
    tm.zero_grad(set_to_none=True)
    tm(torch.from_numpy(mel), torch.from_numpy(labels))[0].backward()
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    assert set(got) == set(want) - {"proj_out.weight"}
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], atol=TOL, err_msg=name)


def test_trainer_keywords_are_ignored(pair):
    """The trainer calls model(x, targets, train=, generator=, date_info=):
    BrainWhisper has no dropout and no session embedding, so none of them
    changes the loss."""
    tm = pair[2]
    mel = torch.from_numpy(_mel(2, 4))
    labels = torch.from_numpy(np.random.default_rng(4).integers(
        0, TINY["n_vocab"], (2, 6)))
    base = float(tm(mel, labels)[0])
    for kw in ({"train": True, "generator": torch.Generator()},
               {"date_info": torch.tensor([0, 0])},
               {"date_info": torch.tensor([3, 17])}):
        assert float(tm(mel, labels, **kw)[0]) == base


def test_cached_decode_matches_full_decode(pair):
    """Prefill of a 3-token prompt and 5 cached steps against the full
    re-forward decode at every step, and against the JAX package's cached
    logits."""
    jm, params, tm = pair
    mel = _mel(2, 5)
    (jl, jc, jlen), (logits, cache, length), _ = _prefill_both(
        pair, mel, 6, prompt=(61, 5, 7))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               atol=LOGIT_TOL)
    enc = tm.encode(torch.from_numpy(mel))
    toks = torch.tensor([61, 5, 7]).repeat(2, 1)
    for _ in range(5):
        full = tm.decode(toks, enc)[:, -1]
        np.testing.assert_allclose(logits.numpy(), full.detach().numpy(),
                                   atol=CACHE_TOL)
        tok = torch.argmax(logits, dim=-1)
        jl, jc, jlen = JAX_CALLS["step"](
            params, jnp.asarray(tok.numpy(), jnp.int32), jc, jlen)
        logits, cache, length = tm.decode_step(tok, cache, length)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        toks = torch.cat([toks, tok[:, None]], dim=1)
    assert length == int(jlen) == 8


def test_decode_step_leaves_its_input_cache_as_it_was(pair):
    """Caches are values, as in the JAX package: a step returns new
    tensors, so one prefilled state can seed several decodes."""
    _, (logits, cache, length), _ = _prefill_both(pair, _mel(2, 6), 4)
    before = [k.clone() for k in cache[0]]
    tok = torch.argmax(logits, dim=-1)
    _, new, _ = pair[2].decode_step(tok, cache, length)
    for k, b in zip(cache[0], before):
        assert torch.equal(k, b)
    assert not torch.equal(new[0][0], cache[0][0])


def test_bf16_dtypes_match_jax():
    """Under bf16 compute a LayerNorm's output takes its f32 weight's
    dtype: the encoder's output is f32, the decoder's residual stream bf16,
    its final norm f32 and the tied head an f32 product; the cross K/V come
    out of a bf16 projection. The same dtypes as the JAX package's."""
    cfg = jconfig.WhisperConfig(**TINY)
    jm = jwhisper.BrainWhisper(cfg, dtype=jnp.bfloat16)
    mel = _mel(2, 7)
    params = jax.eval_shape(jm.init, jax.random.key(1), jnp.asarray(mel),
                            jnp.zeros((2, 4), jnp.int32))
    tm = init_whisper_(whisper.BrainWhisper(tconfig.WhisperConfig(**TINY),
                                            dtype=torch.bfloat16), seed=1)
    jenc = jax.eval_shape(_jit(jm, jwhisper.BrainWhisper.encode), params,
                          jnp.asarray(mel))
    jk, jv = jax.eval_shape(
        _jit(jm, lambda m, e: m.dec_blocks[0].cross_kv(e)), params, jenc)
    _, jlogits = jax.eval_shape(_jit(jm), params, jnp.asarray(mel),
                                jnp.zeros((2, 4), jnp.int32))

    enc = tm.encode(torch.from_numpy(mel))
    k, v = tm.decoder.layers[0].cross_kv(enc)
    streams = []
    hook = tm.decoder.layers[1].register_forward_pre_hook(
        lambda m, a: streams.append(a[0].dtype))
    _, logits = tm(torch.from_numpy(mel), torch.zeros(2, 4,
                                                      dtype=torch.long))
    hook.remove()
    assert (enc.dtype, jenc.dtype) == (torch.float32, jnp.float32)
    assert (k.dtype, v.dtype) == (torch.bfloat16, torch.bfloat16)
    assert (jk.dtype, jv.dtype) == (jnp.bfloat16, jnp.bfloat16)
    assert streams == [torch.bfloat16]
    norm = tm.decoder.layer_norm(torch.zeros(1, 1, TINY["n_text_state"],
                                             dtype=torch.bfloat16))
    assert norm.dtype == torch.float32
    assert (logits.dtype, jlogits.dtype) == (torch.float32, jnp.float32)
    step, _, _ = _prefill_bf16_step(tm, mel)
    assert step.dtype == torch.float32


def _prefill_bf16_step(tm, mel):
    logits, cache, length = tm.prefill(
        torch.tensor(tm.sot_prompt()).repeat(2, 1), torch.from_numpy(mel),
        whisper.init_whisper_cache(tm.cfg, 2, 8))
    return tm.decode_step(torch.argmax(logits, dim=-1), cache, length)


def _as_jax(cache):
    """The port's float (ks, vs, cross) as the JAX package's."""
    ks, vs, cross = cache
    j = lambda t: jnp.asarray(t.numpy())
    return ([j(k) for k in ks], [j(v) for v in vs],
            [(j(k), j(v)) for k, v in cross])


@pytest.mark.parametrize("quant_cross", [True, False])
def test_quantized_cache_codes_are_jax_codes(pair, quant_cross):
    """On the same float cache: codes and scales bitwise equal to the JAX
    package's, each scale the IEEE quotient max(absmax, 1e-6) / 127
    rounded to f32."""
    _, (_, cache, _), _ = _prefill_both(pair, _mel(3, 8), 4)
    jq = jwhisper.quantize_whisper_cache(_as_jax(cache),
                                         quant_cross=quant_cross)
    tq = whisper.quantize_whisper_cache(cache, quant_cross=quant_cross)
    assert tq._fields == jq._fields
    flat = lambda q, pairs: (list(q.ks) + list(q.vs)
                             + [t for kv in pairs for t in kv])
    floats = flat(type(tq)(*cache, (), (), ()), cache[2] if quant_cross
                  else [])
    codes = flat(tq, tq.cross if quant_cross else [])
    jcodes = flat(jq, jq.cross if quant_cross else [])
    scales = list(tq.k_scales) + list(tq.v_scales) + [
        s for kv in tq.cross_scales for s in kv]
    jscales = list(jq.k_scales) + list(jq.v_scales) + [
        s for kv in jq.cross_scales for s in kv]
    if not quant_cross:
        assert tq.cross_scales == () and tq.cross[0][0].dtype == torch.float32
    assert len(codes) == len(scales) == (8 if quant_cross else 4)
    for c, jc8 in zip(codes, jcodes):
        assert c.dtype == torch.int8
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc8))
    for s, js, f in zip(scales, jscales, floats):
        absmax = np.abs(f.numpy()).max(axis=(0, 1)).astype(np.float64)
        ieee = (np.maximum(absmax, 1e-6) / 127.0).astype(np.float32)
        np.testing.assert_array_equal(s.numpy()[0, 0], ieee)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("quant_cross", [True, False])
def test_int8_decode_matches_jax(pair, quant_cross):
    """Three int8 decode steps from the same codes against the JAX
    package's: logits, and the new rows' codes; older codes stay
    untouched."""
    jm, params, tm = pair
    _, (logits, cache, length), _ = _prefill_both(pair, _mel(2, 9), 5)
    jq = jwhisper.quantize_whisper_cache(_as_jax(cache),
                                         quant_cross=quant_cross)
    tq = whisper.quantize_whisper_cache(cache, quant_cross=quant_cross)
    first = tq.ks[0].clone()
    jlen = jnp.int32(length)
    for _ in range(3):
        tok = torch.argmax(logits, dim=-1)
        jl, jq, jlen = JAX_CALLS["step"](
            params, jnp.asarray(tok.numpy(), jnp.int32), jq, jlen)
        logits, tq, length = tm.decode_step(tok, tq, length)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=INT8_TOL)
    assert isinstance(tq, whisper.WhisperQuantCache)
    for k, jk in zip(tq.ks, jq.ks):
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    p = len(pair[0].sot_prompt())
    assert torch.equal(tq.ks[0][:, :p], first[:, :p])


def test_expand_cache_keeps_cross_unreplicated(pair):
    """``expand_cache`` replicates the self-KV to B*W rows and leaves the
    cross K/V at batch B, float and int8; ``reorder_cache`` gathers the
    self-KV only."""
    _, (_, cache, _), _ = _prefill_both(pair, _mel(2, 10), 4)
    w = 3
    for c in (cache, whisper.quantize_whisper_cache(cache)):
        ex = whisper.BrainWhisper.expand_cache(c, w)
        assert ex[0][0].shape[0] == 2 * w and ex[2][0][0].shape[0] == 2
        assert ex[2] is c[2]
        idx = torch.tensor([2, 0, 1, 5, 5, 3])
        re = whisper.BrainWhisper.reorder_cache(ex, idx, group=w)
        assert re[2] is c[2]
        assert torch.equal(re[1][1], ex[1][1][idx])


def test_grouped_cross_attention_matches_replicated(pair):
    """cross_from_kv with B*W queries against batch-B K/V equals the same
    attention against K/V replicated W times."""
    tm = pair[2]
    enc = tm.encode(torch.from_numpy(_mel(2, 11)))
    layer = tm.decoder.layers[0]
    k, v = layer.cross_kv(enc)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (6, 1, TINY["n_text_state"])).astype(np.float32))
    grouped = layer.encoder_attn.cross_from_kv(x, k, v)
    rep = lambda t: t.repeat_interleave(3, dim=0)
    replicated = layer.encoder_attn.cross_from_kv(x, rep(k), rep(v))
    np.testing.assert_allclose(grouped.detach().numpy(),
                               replicated.detach().numpy(), atol=1e-6)


def test_greedy_decode_scan_matches_jax(pair):
    jm, params, tm = pair
    mel = _mel(3, 12)
    (jl, jc, jlen), (logits, cache, length), _ = _prefill_both(pair, mel, 7)
    want = jsampling.greedy_decode_scan(jm, params, jl, jc, jlen,
                                        max_new_tokens=7)
    got = sampling.greedy_decode_scan(tm, logits, cache, length,
                                      max_new_tokens=7)
    assert got.shape == (3, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("int8,length_penalty,eos", [
    (False, 1.0, 62), (False, 0.0, None), (True, 1.0, 62),
    (True, 0.0, None), (False, 1.0, None), (True, 0.0, 62)])
def test_beam_from_prefill_matches_jax(pair, int8, length_penalty, eos):
    """Beams of 3 from one batch-B prefill (cross K/V unreplicated), over
    a float or an int8 cache, at length penalties 1 and 0, with or without
    the EOS freeze: tokens equal to the JAX package's, scores within
    SCORE_TOL."""
    jm, params, tm = pair
    (jl, jc, jlen), (logits, cache, length), _ = _prefill_both(
        pair, _mel(2, 13), 6)
    if int8:
        jc = jwhisper.quantize_whisper_cache(jc)
        cache = whisper.quantize_whisper_cache(cache)
    kw = dict(max_new_tokens=6, beam_width=3, eos_id=eos,
              length_penalty=length_penalty)
    jt, js = jsampling.beam_from_prefill(jm, params, jl, jc, jlen, **kw)
    toks, scores = sampling.beam_from_prefill(tm, logits, cache, length,
                                              **kw)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js),
                               atol=SCORE_TOL)


def test_beam_width_one_is_greedy(pair):
    tm = pair[2]
    _, (logits, cache, length), _ = _prefill_both(pair, _mel(2, 14), 6)
    greedy = sampling.greedy_decode_scan(tm, logits, cache, length,
                                         max_new_tokens=6)
    beam, _ = sampling.beam_from_prefill(tm, logits, cache, length,
                                         max_new_tokens=6, beam_width=1,
                                         length_penalty=0.0)
    assert torch.equal(beam, greedy)


def test_w8a16_is_refused(pair):
    _, (logits, cache, length), _ = _prefill_both(pair, _mel(2, 15), 4)
    with pytest.raises(NotImplementedError, match="int8 KV"):
        pair[2].decode_step(torch.argmax(logits, dim=-1), cache, length,
                            {"qkv_w": None})


def test_seeded_init_scales():
    """init_whisper_: the same weights from the same seed, at the flax
    initialisers' scales."""
    cfg = tconfig.WhisperConfig(**dict(TINY, n_audio_state=64,
                                       n_text_state=64, n_vocab=512))
    a = init_whisper_(whisper.BrainWhisper(cfg), seed=3)
    b = init_whisper_(whisper.BrainWhisper(cfg), seed=3)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    sd = dict(a.named_parameters())
    assert abs(float(sd["model.decoder.embed_tokens.weight"].std())
               - 0.02) < 2e-3
    fc1 = sd["model.encoder.layers.0.fc1.weight"]
    assert abs(float(fc1.std()) * 8.0 - 1.0) < 0.05       # 1/sqrt(64)
    conv = sd["model.encoder.conv2.weight"]               # fan_in 64 x 3
    assert abs(float(conv.std()) * np.sqrt(192) - 1.0) < 0.05
    assert not sd["model.encoder.layers.0.fc1.bias"].any()
    assert bool((sd["model.decoder.layer_norm.weight"] == 1).all())


def test_finding_pipeline_labels_carry_no_end_token():
    """A finding in the JAX pipeline, reproduced: its labels are the
    sentence's ids cut to 30 and padded with -100, no end token
    (``examples/whisper_pipeline.py:66-68``), so a model trained on them is
    never taught its ``eot_id()``, and the WER eval's ``trim_at_eot`` cuts
    only where the model emits that id by chance."""
    from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
    from frankenstein_tpu_torch.whisper_pipeline import tokenize_labels
    tok = ByteTokenizer()
    sentences = ["i want to go home", "a b", "x" * 40]
    labels = tokenize_labels(tok, sentences)
    assert labels.shape == (3, 32)
    np.testing.assert_array_equal(labels[0, :17],
                                  tok.encode("i want to go home"))
    assert (labels[0, 17:] == -100).all() and (labels[2, 30:] == -100).all()
    model = whisper.BrainWhisper(tconfig.WhisperConfig(**TINY),
                                 device="meta")
    assert not np.isin(labels, [model.eot_id(), tok.eot_id]).any()
