"""The port's LFM2-MoE (``models/lfm2.py``), its dropless routed experts
(``models/moe.py:RoutedExperts``) and ``FrankyLfm2`` against the plain
float32 reference (``portbench/reference/franky_lfm2.py``), all float32 on
the CPU, at a tiny size of the published pattern: conv, conv, attention,
conv; one dense and three routed layers of 8 experts, top 2; a vocabulary
of 256. The weights are the benchmark's (``portbench/weights.py`` with the
reference's ``init_rule``), so every parameter is compared."""

import copy

import pytest
import torch
import torch.nn.functional as F

from frankenstein_tpu_torch import config as tconfig
from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
from frankenstein_tpu_torch.decode import pipeline, sampling
from frankenstein_tpu_torch.models import moe
from frankenstein_tpu_torch.models.franky import FrankyLfm2
from frankenstein_tpu_torch.models.lfm2 import HybridCache, Lfm2
from frankenstein_tpu_torch.ops.cuda import moe_route
from portbench import weights
from portbench.reference import franky_lfm2 as ref

torch.set_num_threads(1)

EOT = ref.EOT
V, W = 256, 3
LM = {"vocab_size": V, "hidden_size": 64, "intermediate_size": 96,
      "moe_intermediate_size": 32, "num_hidden_layers": 4,
      "num_attention_heads": 4, "num_key_value_heads": 2,
      "layer_types": ["conv", "conv", "full_attention", "conv"],
      "conv_L_cache": 3, "conv_bias": False, "num_dense_layers": 1,
      "num_experts": 8, "num_experts_per_tok": 2, "use_expert_bias": True,
      "norm_topk_prob": True, "routed_scaling_factor": 1,
      "rope_theta": 1000000, "norm_eps": 1e-5,
      "max_position_embeddings": 128, "tie_word_embeddings": True}
BRAIN = {"encoder": {"window_size": 32, "n_electrodes": 8, "patch_size": 8,
                     "dim": 16, "n_layers": 1, "head_dim": 8,
                     "hidden_dim": 32, "n_heads": 2, "n_kv_heads": 2},
         "n_output_tokens": 4, "output_dim": 64, "dim": 16, "n_layers": 1,
         "head_dim": 8, "hidden_dim": 32, "n_heads": 2, "n_kv_heads": 2}
MC = {"brain": BRAIN, "lm": LM}


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def franky():
    """(FrankyLfm2, the benchmark's f32 weights by name)."""
    model = FrankyLfm2(tconfig.FrankyLfm2Config.from_dict(
        copy.deepcopy(MC))).eval()
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    params = weights.make(shapes, ref.init_rule, 5, "cpu",
                          n_layer=ref.n_layer(MC))
    weights.load(model, params)
    return model, params


def windows(b: int, seed: int = 0):
    return torch.randn(b, 32, 8, generator=torch.Generator().manual_seed(seed))


def ids(shape, seed: int):
    return torch.randint(0, V, shape, generator=torch.Generator().manual_seed(
        seed))


def full_logits(model, tokens, prefix):
    return model.llm_model.logits(tokens, prefix)


def test_config_reads_hf_keys():
    cfg = tconfig.Lfm2MoeConfig.from_dict(dict(LM, model_type="lfm2_moe"))
    assert cfg.head_dim == 16 and cfg.attention_layers == (2,)
    big = tconfig.Lfm2MoeConfig()
    assert big.attention_layers == (2, 6, 10, 14, 18, 21)
    assert tconfig.FrankyLfm2Config().brain.output_dim == big.hidden_size


def test_full_forward_logits_match_the_reference(franky):
    model, params = franky
    x, toks = windows(2), ids((2, 5), 1)
    with torch.no_grad():
        prefix = model.encode(x)
        start = torch.full((2, 1), EOT, dtype=torch.long)
        got = full_logits(model, torch.cat([start, toks[:, :-1]], 1), prefix)
    want = ref.served_logits(x, toks, params, MC)
    assert got.shape == (2, 5, V)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("n_prompt", [1, 3])
def test_prefill_and_decode_equal_the_full_forward(franky, n_prompt):
    """Prefill over the prefix and the first tokens, then one decode step a
    token through the hybrid cache: the full forward's logits at every
    position."""
    model, _ = franky
    toks = ids((2, 7), 2)
    with torch.no_grad():
        prefix = model.encode(windows(2, 3))
        want = full_logits(model, toks, prefix)
        cache = model.init_decode_cache(2, 16)
        logits, cache, length = model.prefill(toks[:, :n_prompt], prefix,
                                              cache)
        steps = [logits]
        for i in range(n_prompt, toks.shape[1]):
            logits, cache, length = model.decode_step(toks[:, i], cache,
                                                      length)
            steps.append(logits)
    got = torch.stack(steps, dim=1)
    assert length == 4 + toks.shape[1]
    assert _rel(got, want[:, n_prompt - 1:]) < 1e-5


def _reordered_step(model, reorder):
    """(the logits of one decode step after ``reorder`` moved a prefilled
    6-row cache to the parents ``flat``, the full forward of the permuted
    histories and the new token)."""
    b = 2 * W
    hist, new = ids((b, 4), 4), ids((b,), 5)
    flat = torch.tensor([2, 0, 0, 4, 5, 3])       # parents inside each group
    with torch.no_grad():
        prefix = model.encode(windows(2, 6)).repeat_interleave(W, 0)
        cache = model.init_decode_cache(b, 16)
        _, cache, length = model.prefill(hist, prefix, cache)
        cache = reorder(cache, flat, W)
        got, _, _ = model.decode_step(new, cache, length)
        fresh = full_logits(model, torch.cat([hist[flat], new[:, None]], 1),
                            prefix[flat])[:, -1]
    return got, fresh


def test_beam_reorder_moves_kv_rows_and_conv_state(franky):
    model, _ = franky
    got, want = _reordered_step(model, lambda c, f, w: model.reorder_cache(
        c, f, group=w))
    assert _rel(got, want) < 1e-5
    got, want = _reordered_step(model, lambda c, f, w: model.reorder_cache(
        c, f, group=0))
    assert _rel(got, want) < 1e-5


def test_a_reorder_that_skips_the_conv_state_fails(franky):
    model, _ = franky

    def kv_only(cache, flat, w):
        conv = cache.conv.clone()          # the reorder moves it in place
        moved = model.reorder_cache(cache, flat, group=w)
        return HybridCache(moved.k, moved.v, conv)

    got, want = _reordered_step(model, kv_only)
    assert _rel(got, want) > 1e-3


@pytest.mark.parametrize("group", [0, W])
def test_reorder_moves_the_state_in_place(franky, group):
    """The reorder writes the cache's own tensors (the state the card's
    step graphs hold stays theirs) and returns that cache."""
    model, _ = franky
    with torch.no_grad():
        prefix = model.encode(windows(2 * W, 9))
        cache = model.init_decode_cache(2 * W, 8)
        _, cache, _ = model.prefill(ids((2 * W, 2), 10), prefix, cache)
    flat = torch.tensor([2, 0, 0, 4, 5, 3])
    want = [t.index_select(1, flat) for t in cache]
    ptrs = [t.data_ptr() for t in cache]
    moved = model.reorder_cache(cache, flat, group=group)
    assert moved is cache and [t.data_ptr() for t in moved] == ptrs
    for got, exp in zip(moved, want):
        assert torch.equal(got, exp)


@pytest.mark.parametrize("length,t", [(0, 5), (7, 1), (90, 3)])
def test_rope_rows_depend_only_on_their_positions(franky, length, t):
    """Each call computes its rows afresh, equal to those rows of the whole
    table, whatever ran before (a captured step holds on to them)."""
    model, _ = franky
    lm = model.llm_model
    lm._rope_rows(0, 120)
    cos, sin = lm._rope_rows(length, t)
    all_cos, all_sin = lm._rope_rows(0, length + t)
    assert torch.equal(cos, all_cos[length:]) and torch.equal(
        sin, all_sin[length:])
    hd = LM["hidden_size"] // LM["num_attention_heads"]
    inv = 1.0 / 1e6 ** (torch.arange(0, hd, 2).float() / hd)
    ang = torch.arange(length, length + t).float()[:, None] * inv
    assert torch.allclose(cos[:, :hd // 2], torch.cos(ang))
    assert torch.equal(cos[:, :hd // 2], cos[:, hd // 2:])


def test_expand_cache_repeats_every_part(franky):
    model, _ = franky
    with torch.no_grad():
        prefix = model.encode(windows(2, 7))
        cache = model.init_decode_cache(2, 8)
        _, cache, _ = model.prefill(ids((2, 2), 8), prefix, cache)
    big = model.expand_cache(cache, W)
    for part, small in zip(big, cache):
        assert part.shape[1] == 2 * W
        assert torch.equal(part[:, W:2 * W], small[:, 1:2].expand_as(
            part[:, W:2 * W]))


def _experts(seed: int = 0, bias: bool = True):
    layer = moe.RoutedExperts(32, 16, 8, 2, use_expert_bias=bias,
                              layer=-1 - seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return layer


def _per_token(layer, h):
    """Each token through its chosen experts one at a time."""
    chosen, w = layer.route(h)
    out = torch.zeros_like(h)
    f = layer.hidden_dim
    for i in range(h.shape[0]):
        for j in range(layer.k):
            e = int(chosen[i, j])
            a = h[i] @ layer.gate_up_proj[e]
            y = (F.silu(a[:f]) * a[f:]) @ layer.down_proj[e]
            out[i] += w[i, j] * y
    return out


@pytest.mark.parametrize("n_tok", [1, 5, 40])
def test_grouped_layer_equals_the_per_token_loop(n_tok):
    layer = _experts(1)
    h = torch.randn(n_tok, 32, generator=torch.Generator().manual_seed(2))
    calls = moe.grouped_calls
    moe.expert_ends.pop(layer.layer, None)
    with torch.no_grad():
        got = layer(h[None])[0]
        want = _per_token(layer, h)
    assert moe.grouped_calls == calls + 2
    assert _rel(got, want) < 1e-5
    assert int(moe.expert_ends[layer.layer][-1]) == n_tok * layer.k


def test_skewed_routing_keeps_every_token():
    """A bias that sends every token to experts 3 and 5: the GShard layer's
    capacity would keep under a third of them; the dropless layer computes
    every pair."""
    layer = _experts(3)
    with torch.no_grad():
        layer.expert_bias.zero_()
        layer.expert_bias[[3, 5]] = 10.0
    n = 64
    h = torch.randn(n, 32, generator=torch.Generator().manual_seed(4))
    gshard = moe.MoESwiGLU(32, 16, 8, 2)
    assert gshard.capacity(n, n) < n // 3
    moe.expert_ends.pop(layer.layer, None)
    with torch.no_grad():
        chosen, _ = layer.route(h)
        got = layer(h)
        want = _per_token(layer, h)
    assert set(chosen.flatten().tolist()) == {3, 5}
    assert _rel(got, want) < 1e-5
    assert (got.abs().sum(-1) > 0).all()
    ends = moe.expert_ends[layer.layer]
    rows = torch.diff(ends, prepend=ends.new_zeros(1))
    assert rows[3] == n and rows[5] == n and int(rows.sum()) == 2 * n


def test_bias_changes_the_selection_not_the_weights():
    layer = _experts(5)
    h = torch.randn(200, 32, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        picked, w = layer.route(h)
        saved = layer.expert_bias.clone()
        layer.expert_bias.zero_()
        plain, _ = layer.route(h)
        layer.expert_bias.copy_(saved)
        scores = torch.sigmoid(h @ layer.gate.weight.t())
    moved = (picked.sort(-1).values != plain.sort(-1).values).any(-1)
    assert 0.1 < float(moved.float().mean()) < 1.0
    at = torch.gather(scores, -1, picked)
    assert torch.allclose(w, at / (at.sum(-1, keepdim=True) + 1e-6))
    assert torch.allclose(w.sum(-1), torch.ones(200), atol=1e-5)


def _routed(case: str, n: int, seed: int = 11):
    """(a layer of LFM2's routing width, 32 experts, top 4, and h [n, 64]):
    ``skewed`` sends every row to expert 7, ``idle`` no row to expert 3,
    ``ties`` quantizes h and the gate so every score is exact in f32 and
    gives experts 1, 9 and 31 the gate rows and biases of 0, 5 and 20."""
    layer = moe.RoutedExperts(64, 16, 32, 4, layer=-100 - seed)
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, 64, generator=g)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        bias, gate = layer.expert_bias, layer.gate.weight
        if case == "skewed":
            bias[7] = 10.0
        elif case == "idle":
            bias[3] = -10.0
        elif case == "ties":
            h = torch.randint(-4, 5, h.shape, generator=g) / 4
            gate.copy_(torch.randint(-4, 5, gate.shape, generator=g) / 64)
            bias.copy_(torch.randint(-2, 3, bias.shape, generator=g) / 64)
            for lo, hi in ((0, 1), (5, 9), (20, 31)):
                gate[hi], bias[hi] = gate[lo], bias[lo]
    return layer, h


def _todays_chain(layer, h, stable: bool):
    """The layer as it ran before its routing became two kernels: f32
    scores, ``torch.topk`` (``moe.stable_topk`` if ``stable``), the
    weights, a stable ``torch.sort`` by expert, ``searchsorted``, the
    grouped products, ``index_copy_`` and ``bmm``."""
    n, k, f = h.shape[0], layer.k, layer.hidden_dim
    scores = torch.sigmoid(h.float() @ layer.gate.weight.float().t())
    pick = scores + layer.expert_bias.float()
    chosen = (moe.stable_topk(pick, k)[1] if stable
              else torch.topk(pick, k, dim=-1).indices)
    weights = torch.gather(scores, -1, chosen)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    experts, order = torch.sort(chosen.reshape(-1), stable=True)
    ends = torch.searchsorted(experts, torch.arange(layer.n_experts),
                              right=True, out_int32=True)
    gu = torch._grouped_mm(h[order // k], layer.gate_up_proj, offs=ends)
    y = torch._grouped_mm(F.silu(gu[:, :f]) * gu[:, f:], layer.down_proj,
                          offs=ends)
    y = torch.empty_like(y).index_copy_(0, order, y).view(n, k, -1)
    out = torch.bmm(weights[:, None], y)[:, 0]
    return {"chosen": chosen, "weights": weights, "ends": ends,
            "rows": order // k, "order": order, "pick": pick, "out": out}


@pytest.mark.parametrize("case", ["random", "skewed", "idle", "ties"])
@pytest.mark.parametrize("n", [160, 5280])
def test_routing_twins_equal_the_chain_they_replace(n, case, monkeypatch):
    """The route and combine kernels' twins (``ops/cuda/moe_route.py``), as
    the layer runs them on the CPU, give exactly what the sort, offsets,
    unsort and ``bmm`` they replace gave: the choices, weights, offsets,
    sorted source rows, running counts and the layer's output. Ties in s
    + bias go to the lower expert index, where ``torch.topk`` promises no
    order, so the tied case holds the old chain to that rule."""
    layer, h = _routed(case, n)
    k = layer.k
    monkeypatch.setattr(moe, "expert_ends", {})   # 32 experts, not the LM's
    with torch.no_grad():
        want = _todays_chain(layer, h, stable=case == "ties")
        r = moe_route.route(h, layer.gate.weight, layer.expert_bias, k)
        got = layer(h)
        layer(h)
    assert torch.equal(r.chosen.long(), want["chosen"])
    assert torch.equal(r.weights, want["weights"])
    assert torch.equal(r.ends, want["ends"])
    assert torch.equal(r.rows.long(), want["rows"])
    assert torch.equal(r.pos.reshape(-1)[want["order"]],
                       torch.arange(n * k, dtype=torch.int32))
    assert torch.equal(got, want["out"])
    assert torch.equal(moe.expert_ends[layer.layer], 2 * want["ends"].long())
    rows = torch.diff(r.ends, prepend=r.ends.new_zeros(1))
    assert int(rows.sum()) == n * k
    if case == "skewed":
        assert rows[7] == n
    if case == "idle":
        assert rows[3] == 0
    if case == "ties":
        # the pick's k-th and (k+1)-th values tie on many rows, and each
        # row's choices are its top k by (value down, expert up)
        ranked = want["pick"].sort(-1, descending=True).values
        assert int((ranked[:, k - 1] == ranked[:, k]).sum()) > n // 20
        for i in range(0, n, max(1, n // 40)):
            order = sorted(range(32), key=lambda e: (
                -float(want["pick"][i, e]), e))
            assert r.chosen[i].tolist() == order[:k]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_twin_equals_index_copy_and_bmm(dtype):
    """Each row's k outputs gathered at their sorted positions and summed
    with its weights in the compute dtype: the unsort by ``index_copy_``
    and the ``bmm`` it replaces, bitwise."""
    n, k, d = 96, 4, 48
    g = torch.Generator().manual_seed(3)
    chosen = torch.randint(0, 16, (n, k), generator=g)
    order = torch.sort(chosen.reshape(-1), stable=True).indices
    pos = torch.empty_like(order).index_copy_(0, order,
                                              torch.arange(n * k)).view(n, k)
    y = torch.randn(n * k, d, generator=g).to(dtype)
    w = torch.rand(n, k, generator=g)
    want = torch.bmm(w.to(dtype)[:, None], torch.empty_like(y).index_copy_(
        0, order, y).view(n, k, -1))[:, 0]
    got = moe_route.combine(y, w, pos.int())
    assert got.dtype == dtype and torch.equal(got, want)


def test_franky_lfm2_beams_through_the_predictor(franky):
    """``make_franky_predictor`` -> ``beam_search`` serves the reference's
    beams: the same tokens and scores."""
    model, params = franky
    x = windows(2, 9)
    got = {}

    def keep(fn):
        def wrapped(*a, **kw):
            got["out"] = fn(*a, **kw)
            return got["out"]
        return wrapped

    predict = pipeline.make_franky_predictor(
        model, ByteTokenizer(), max_new_tokens=6, beam_width=W, eot_id=EOT)
    saved = sampling.beam_search
    sampling.beam_search = keep(saved)
    try:
        texts = predict(x.numpy())
    finally:
        sampling.beam_search = saved
    toks, scores = got["out"]
    want_toks, want_scores = ref.decode(x, params, MC, {
        "max_new_tokens": 6, "beam_width": W})
    assert len(texts) == 2
    assert torch.equal(toks, want_toks)
    assert torch.allclose(scores, want_scores, atol=1e-5)


def test_int8_modes_raise_with_their_reason(franky):
    model, _ = franky
    prefix = torch.zeros(2, 4, 64)
    idx0 = torch.full((2, 1), EOT, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="hybrid cache"):
        sampling.generate(model, idx0, prefix, max_new_tokens=2, top_k=5,
                          int8_kv=True)
    with pytest.raises(NotImplementedError, match="w8a16"):
        sampling.decode_weights(model, int8_weights=True)


def test_decode_weights_ask_an_unknown_lm():
    assert sampling.decode_weights(Lfm2(tconfig.Lfm2MoeConfig.from_dict(LM)),
                                   int8_weights=False) is None

    class Other(torch.nn.Module):
        pass

    with pytest.raises(TypeError, match="no stacked decode weights"):
        sampling.decode_weights(Other(), int8_weights=False)


def _card_model():
    """The tiny LM in bf16 on the card with random weights, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's CUDA graphs run only "
                    "on the card")
    dev = torch.device("cuda")
    model = Lfm2(tconfig.Lfm2MoeConfig.from_dict(LM), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.1)
    return model.to(torch.bfloat16).eval(), g


@pytest.mark.cuda
def test_step_graphs_replay_the_layers_on_the_card():
    """On the card ``decode_step`` replays one CUDA graph a position: the
    same logits and state as the layers run one by one, through a beam
    reorder between steps, with the replays' grouped products and route
    and combine kernels counted (one of each kernel a routed layer).
    The graphs take the caller's cache in once and hand back the state
    they hold, which the in-place reorder keeps theirs."""
    model, g = _card_model()
    dev = g.device
    b = 2 * W
    hist = torch.randint(0, V, (b, 4), generator=g, device=dev)
    prefix = torch.randn(b, 4, 64, generator=g, device=dev)
    flat = torch.tensor([2, 0, 0, 4, 5, 3], device=dev)
    caches = []
    for _ in range(2):
        cache = model.init_decode_cache(b, 16)
        caches.append(model.prefill(hist, prefix, cache)[1])
    length, routed = 8, 3
    for i in range(4):
        tok = torch.randint(0, V, (b,), generator=g, device=dev)
        calls = moe.grouped_calls
        routes, combines = moe_route.launches, moe_route.combine_launches
        got, caches[0], _ = model.decode_step(tok, caches[0], length + i)
        assert moe.grouped_calls - calls in (2 * routed, 4 * routed)
        assert moe_route.launches - routes in (routed, 2 * routed)
        assert moe_route.combine_launches - combines == (
            moe_route.launches - routes)
        with torch.no_grad():
            want = model._step(tok, caches[1], length + i)
        assert _rel(got, want) < 1e-3
        for mine, theirs in zip(caches[0], caches[1]):
            assert _rel(mine.float(), theirs.float()) < 1e-3
        caches = [model.reorder_cache(c, flat, group=W) for c in caches]
    assert len(model._graphs.graphs) == 4
    (_, held, _), = model._graphs.held.values()
    assert all(a is b for a, b in zip(caches[0], held))
    # a captured position again: its replay alone, one route and one
    # combine launch a routed layer
    counts = (moe.grouped_calls, moe_route.launches,
              moe_route.combine_launches)
    model.decode_step(tok, caches[0], length)
    assert (moe.grouped_calls - counts[0], moe_route.launches - counts[1],
            moe_route.combine_launches - counts[2]) == (2 * routed, routed,
                                                         routed)


@pytest.mark.cuda
def test_step_graphs_replay_alike_after_a_longer_request():
    """A request that decodes far past a short one's positions (and a
    full forward longer still) leaves the short request's graphs reading
    what they read when captured: its steps, replayed again, equal the
    layers run one by one."""
    model, g = _card_model()
    dev = g.device
    b, length = 2 * W, 8
    hist = torch.randint(0, V, (b, 4), generator=g, device=dev)
    prefix = torch.randn(b, 4, 64, generator=g, device=dev)
    toks = torch.randint(0, V, (48, b), generator=g, device=dev)

    def request(max_len: int, steps: int, check: bool):
        caches = [model.prefill(hist, prefix, model.init_decode_cache(
            b, max_len))[1] for _ in range(2)]
        for i in range(steps):
            got, caches[0], _ = model.decode_step(toks[i], caches[0],
                                                  length + i)
            if check:
                with torch.no_grad():
                    want = model._step(toks[i], caches[1], length + i)
                assert _rel(got, want) < 1e-3, i

    request(16, 4, False)
    request(64, 40, False)
    with torch.no_grad():
        model.logits(toks.t()[:, :40], prefix)
    request(16, 4, True)
    assert len(model._graphs.graphs) == 44
