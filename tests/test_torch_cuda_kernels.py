"""Kernels K1, K2 (bf16 and int8 KV caches, its launch knobs, a cache too
long for shared-memory scores), K3, K4, K5 (bf16 and int8 KV caches, one
to four query heads per KV head, the 1B-class width), K6 / K7 (the three mask
modes of flash attention, forward and backward: K7 slab's unmasked and
masked instances at P = 256, 96, 64, 8 and 1), K8 (the fused head and
top-k: B from 1 to 300, k = 1, 10 and 32, a ragged vocab with its top-k in
the tail, a table of width 1024 and 1600, ties, its launch and kept
scratch), K9 (the fused pre-norm SwiGLU MLP, both norms),
K10 (int8 QK scores: K and Q codes, scales, out and lse) and the routed
experts' route and combine kernels (ops/cuda/moe_route.py), and the probe
modes of K1's and K10's forwards (ops/cuda/slab_probe.py), on the card against
their plain PyTorch twins, at
small shapes that reach the kernels' edge cases (slabs that do not divide
the tiles, a batch that does not fill a tile, an empty cache, one beam and
the widest group, unsorted positions, slab ids whose first key tile most
rows do not see, a ragged last row tile), the
gradients of an encoder through K1 and K4 and of an MAE through K6 and K7
against their f32 CPU twins, and training steps through the train CLI that
the kernels do not take (f32 compute, an MAE of 100 channels), which run
the plain routes.

The kernels have no CPU mode, so without a CUDA device these tests skip.
On the card: ``python -m pytest tests/test_torch_cuda_kernels.py -q``.
"""

import math

import pytest
import torch

from frankenstein_tpu_torch.ops import rope
from frankenstein_tpu_torch.ops.cuda import beam_reorder as k3
from frankenstein_tpu_torch.ops.cuda import flash_attention as k67
from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
from frankenstein_tpu_torch.ops.cuda import fused_llama_decode as k5
from frankenstein_tpu_torch.ops.cuda import fused_mlp as k9
from frankenstein_tpu_torch.ops.cuda import moe_route as mr
from frankenstein_tpu_torch.ops.cuda import slab_attention as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("b,t,h,d,p", [(1, 256, 2, 32, 64),
                                       (2, 384, 3, 32, 100),
                                       (1, 256, 2, 64, 16),
                                       (2, 512, 2, 32, 512),
                                       (1, 384, 4, 32, 96),
                                       (2, 512, 2, 32, 192),
                                       (1, 384, 2, 64, 100),
                                       (1, 512, 2, 64, 128),
                                       (1, 6144, 8, 32, 256)])
def test_k1_matches_twin(dev, b, t, h, d, p):
    """bf16 kernel vs the twin in f32 on the same bf16 inputs; the kernel
    rounds rotated q/k and the probabilities to bf16, hence 3e-2. P=96 and
    100 take the masked instance; at P=192 the two warpgroups of a 128-row
    CTA end at different keys."""
    gen = torch.Generator(device=dev).manual_seed(b * t + p)
    q, k, v = (torch.randn(b, t, h * d, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    cos, sin = rope.folded_tables(rope.build_rope_cache(d, t + 5,
                                                        device=dev)[-t:], 1)
    before = k1.launches
    out, lse = k1.slab_rope_attention(q, k, v, cos, sin, n_heads=h,
                                      tok_per_time=p)
    assert k1.launches == before + 1
    ref, ref_lse = k1.slab_rope_attention_ref(
        q.float(), k.float(), v.float(), cos, sin, n_heads=h, tok_per_time=p)
    assert _err(out, ref) < 3e-2
    assert _err(lse, ref_lse) < 3e-2


@pytest.mark.parametrize("d,p", [(32, 256), (32, 96), (64, 100)])
def test_k1_is_deterministic_and_prep_is_k4s(dev, d, p):
    """Two K1 launches bitwise equal; K1's pre-pass writes qr and kr
    bitwise as K4's pre-pass does (the rotation K4 recomputes K1's scores
    with), and does not count as a K1 launch."""
    b, t, h = 2, 512, 2
    args, kw = _k4_case(dev, b, t, h, d, p, seed=d + p)
    q, k, v, cos, sin, out, lse, dout = args
    before = k1.launches
    again = k1.slab_rope_attention(q, k, v, cos, sin, **kw)
    qr, kr = k1.slab_rope_fwd_prep(q, k, cos, sin, n_heads=h)
    bqr, bkr, _ = k1.slab_rope_bwd_prep(q, k, cos, sin, out, dout,
                                        n_heads=h)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert torch.equal(qr, bqr) and torch.equal(kr, bkr)
    rq, rk = k1.slab_rope_fwd_prep_ref(q, k, cos, sin, n_heads=h)
    assert torch.equal(qr, rq) and torch.equal(kr, rk)


@pytest.mark.parametrize("p", [256, 96])
def test_k1_occupancy_reads_every_pass(dev, p):
    for d in (32, 64):
        for pass_ in k1.FWD_PASSES:
            regs, ctas = k1.fwd_occupancy(pass_, d, p)
            assert 0 < regs <= 255 and ctas >= 1, (pass_, d, regs, ctas)
    with pytest.raises(RuntimeError, match="occupancy"):
        k1.fwd_occupancy("fwd", 48, p)


def test_k1_refuses_what_it_does_not_take(dev):
    q = torch.zeros(1, 200, 64, dtype=torch.bfloat16, device=dev)
    cos = torch.zeros(200, 32, device=dev)
    with pytest.raises(ValueError, match="T % 128"):
        k1.slab_rope_attention(q, q, q, cos, cos, n_heads=2, tok_per_time=8)
    with pytest.raises(ValueError, match="bf16"):
        k1.slab_rope_attention(q.float(), q, q, cos, cos, n_heads=2,
                               tok_per_time=8)


K4_TOL = 2e-2   # relative to max |twin|: ds, p, dq and dk round to bf16


def _k4_case(dev, b, t, h, d, p, seed, dout=None):
    """bf16 q, k, v and dout; out and lse from K1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, t, h * d, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    if dout is None:
        dout = torch.randn(b, t, h * d, generator=gen,
                           device=dev).to(torch.bfloat16)
    cos, sin = rope.folded_tables(rope.build_rope_cache(d, t + 3,
                                                        device=dev)[-t:], 1)
    kw = dict(n_heads=h, tok_per_time=p)
    out, lse = k1.slab_rope_attention(q, k, v, cos, sin, **kw)
    return (q, k, v, cos, sin, out, lse, dout), kw


@pytest.mark.parametrize("b,t,h,d,p", [(1, 256, 2, 32, 64),
                                       (2, 384, 3, 32, 100),
                                       (1, 256, 2, 64, 16),
                                       (2, 512, 2, 32, 512),
                                       (1, 768, 2, 32, 256),
                                       (1, 640, 2, 32, 64),
                                       (2, 512, 2, 32, 8),
                                       (1, 384, 4, 32, 96),
                                       (1, 256, 2, 64, 256),
                                       (1, 512, 2, 32, 512)])
def test_k4_matches_twin_and_is_deterministic(dev, b, t, h, d, p):
    """bf16 kernel vs the twin in f32 on the same bf16 inputs and the same
    K1 residuals; two launches bitwise equal. P a multiple of 64 takes the
    unmasked instance, any other P the masked one; T=768 puts 192-row CTAs
    across slab boundaries, T=640 is no multiple of 192."""
    args, kw = _k4_case(dev, b, t, h, d, p, seed=b * t + p)
    before = k1.launches_bwd
    got = k1.slab_rope_attention_bwd(*args, **kw)
    again = k1.slab_rope_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert k1.launches_bwd == before + 2
    want = k1.slab_rope_attention_bwd_ref(*(x.float() for x in args), **kw)
    for name, g, a, w in zip("qkv", got, again, want):
        assert torch.equal(g, a), name
        assert _err(g, w) <= K4_TOL * float(w.abs().max()), name


@pytest.mark.parametrize("d,p", [(32, 64), (64, 100)])
def test_k4_probability_rows_sum_to_one(dev, d, p):
    """dout one-hot on (query i_c, lane c) turns column c of dv into row
    i_c of the probabilities K4 recomputes from K1's lse: each sums to 1."""
    b, t, h = 2, 512, 2
    rows = torch.arange(d, device=dev) * 13 % t
    dout = torch.zeros(b, t, h * d, dtype=torch.bfloat16, device=dev)
    for head in range(h):
        dout[:, rows, head * d + torch.arange(d, device=dev)] = 1.0
    args, kw = _k4_case(dev, b, t, h, d, p, seed=7, dout=dout)
    _, _, dv = k1.slab_rope_attention_bwd(*args, **kw)
    sums = dv.float().reshape(b, t, h, d).sum(dim=1)
    assert float((sums - 1.0).abs().max()) < 1e-2


@pytest.mark.parametrize("d", [32, 64])
def test_k4_prep_matches_twin(dev, d):
    """K4's pre-pass: qr and kr bitwise equal to the twin's rotation (K1's
    arithmetic), delta within 1e-6 of max |twin| (f32 sums in another
    order); it counts no K4 launch."""
    args, kw = _k4_case(dev, 2, 384, 3, d, 96, seed=d)
    q, k, _, cos, sin, out, _, dout = args
    before = k1.launches_bwd
    qr, kr, delta = k1.slab_rope_bwd_prep(q, k, cos, sin, out, dout,
                                          n_heads=3)
    torch.cuda.synchronize()
    assert k1.launches_bwd == before
    rq, rk, rd = k1.slab_rope_bwd_prep_ref(q, k, cos, sin, out, dout,
                                           n_heads=3)
    assert torch.equal(qr, rq) and torch.equal(kr, rk)
    assert _err(delta, rd) <= 1e-6 * float(rd.abs().max())


def test_k4_after_qk_int8_forward(dev):
    """A qk_int8 forward (K10) then K4 on its out and lse, through the
    autograd Function: the gradients are K4's on K10's residuals, within
    K4_TOL of the twin on the same residuals."""
    b, t, h, d, p = 1, 1024, 2, 32, 256
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v, dout = (torch.randn(b, t, h * d, generator=gen, device=dev)
                     .to(torch.bfloat16) for _ in range(4))
    cos, sin = rope.folded_tables(rope.build_rope_cache(d, t, device=dev),
                                  1)
    kw = dict(n_heads=h, tok_per_time=p)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (k1.launches, k1.launches_int8, k1.launches_bwd)
    out = k1.SlabRopeAttention.apply(*leaves, cos, sin, h, p, True)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_int8, k1.launches_bwd) == (
        before[0], before[1] + 1, before[2] + 1)
    o8, lse8 = k1.slab_rope_attention(q, k, v, cos, sin, qk_int8=True, **kw)
    want = k1.slab_rope_attention_bwd_ref(
        *(x.float() for x in (q, k, v, cos, sin, o8, lse8, dout)), **kw)
    for name, leaf, w in zip("qkv", leaves, want):
        assert torch.isfinite(leaf.grad).all(), name
        assert _err(leaf.grad, w) <= K4_TOL * float(w.abs().max()), name


@pytest.mark.parametrize("p", [256, 96])
def test_k4_occupancy_reads_every_pass(dev, p):
    for d in (32, 64):
        for pass_ in k1.BWD_PASSES:
            regs, ctas = k1.bwd_occupancy(pass_, d, p)
            assert 0 < regs <= 255 and ctas >= 1, (pass_, d, regs, ctas)


def test_k4_refuses_what_it_does_not_take(dev):
    x = torch.zeros(1, 200, 64, dtype=torch.bfloat16, device=dev)
    cos = torch.zeros(200, 32, device=dev)
    lse = torch.zeros(1, 2, 200, device=dev)
    with pytest.raises(ValueError, match="T % 128"):
        k1.slab_rope_attention_bwd(x, x, x, cos, cos, x, lse, x, n_heads=2,
                                   tok_per_time=8)
    x = torch.zeros(1, 256, 64, dtype=torch.bfloat16, device=dev)
    cos = torch.zeros(256, 32, device=dev)
    with pytest.raises(ValueError, match="lse"):
        k1.slab_rope_attention_bwd(x, x, x, cos, cos, x, lse, x, n_heads=2,
                                   tok_per_time=8)


def test_encoder_attention_gradients_match_twin(dev):
    """Every encoder attention weight gets a gradient through K1 and K4
    that matches the f32 CPU twin's (a kernel call without autograd would
    leave qw, kw, vw with none)."""
    from frankenstein_tpu_torch.config import MAEConfig
    from frankenstein_tpu_torch.models.brainformer import Encoder
    cfg = MAEConfig(window_size=64, n_electrodes=64, patch_size=16, dim=64,
                    n_layers=2, head_dim=32, hidden_dim=128, n_heads=2)
    torch.manual_seed(0)
    ref = Encoder(cfg)                                  # f32, CPU
    card = Encoder(cfg, device=dev, dtype=torch.bfloat16)   # f32 params
    card.load_state_dict(ref.state_dict())
    x = torch.randn(2, 64, 64)
    w = torch.randn(2, cfg.block_size, cfg.dim)
    (ref(x) * w).sum().backward()
    before = (k1.launches, k1.launches_bwd)
    (card(x.to(dev).to(torch.bfloat16)).float() * w.to(dev)).sum().backward()
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_bwd) == (before[0] + 2, before[1] + 2)
    for (name, pr), pc in zip(ref.named_parameters(), card.parameters()):
        if ".attn." not in name:
            continue
        assert pc.grad is not None, name
        rel = float((pc.grad.cpu() - pr.grad).norm() / pr.grad.norm())
        assert rel < 5e-2, (name, rel)


def test_encoder_remat_recomputes_through_the_kernels(dev):
    """With remat each block's forward (K1 included) runs again in the
    backward; the gradients are those of the plain run."""
    from frankenstein_tpu_torch.config import MAEConfig
    from frankenstein_tpu_torch.models.brainformer import Encoder
    cfg = MAEConfig(window_size=64, n_electrodes=64, patch_size=16, dim=64,
                    n_layers=2, head_dim=32, hidden_dim=128, n_heads=2)
    torch.manual_seed(1)
    enc = Encoder(cfg, device=dev, dtype=torch.bfloat16)
    x = torch.randn(2, 64, 64, device=dev).to(torch.bfloat16)
    w = torch.randn(2, cfg.block_size, cfg.dim, device=dev)
    grads, counts = [], []
    for remat in (False, True):
        enc.zero_grad()
        before = (k1.launches, k1.launches_bwd)
        (enc(x, remat).float() * w).sum().backward()
        torch.cuda.synchronize()
        counts.append((k1.launches - before[0], k1.launches_bwd - before[1]))
        grads.append([p.grad.clone() for p in enc.parameters()])
    assert counts == [(2, 2), (4, 2)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _k2_weights(gen, dev, n_layer, e, w8):
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev) * 0.05
    st = {key: rnd(n_layer, n) for key, n in (
        ("ln1_w", e), ("ln1_b", e), ("qkv_b", 3 * e), ("proj_b", e),
        ("ln2_w", e), ("ln2_b", e), ("fc_b", 4 * e), ("fc2_b", e))}
    for key, shape in (("qkv_w", (e, 3 * e)), ("proj_w", (e, e)),
                       ("fc_w", (e, 4 * e)), ("fc2_w", (4 * e, e))):
        st[key] = rnd(n_layer, *shape).to(torch.bfloat16)
    return k2.quantize_weights(st) if w8 else st


def _k2_twice(x, st, kc, vc, length, ks=None, vs=None, *, n_head):
    """Two launches on copies of the caches: their outputs, bitwise equal,
    and the launch count they added (asserted 2)."""
    before = k2.launches
    outs = []
    for _ in range(2):
        kc_k, vc_k = kc.clone(), vc.clone()
        xo, _, _ = k2.fused_decode_blocks(x, st, kc_k, vc_k, length, ks, vs,
                                          n_head=n_head)
        outs.append((xo, kc_k, vc_k))
    torch.cuda.synchronize()
    assert k2.launches == before + 2
    assert all(torch.equal(a, c) for a, c in zip(*outs))
    return outs[0]


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("b,length", [(8, 5), (40, 0), (3, 15), (300, 9),
                                      (13, 2)])
def test_k2_matches_twin(dev, w8, b, length):
    """x and the new rows within K2's tolerance, every other row untouched,
    two launches bitwise equal; batches that pad the wgmma N (3, 13), fill
    several N chunks (300) and leave the cache empty (length 0)."""
    n_layer, h, e, s = 2, 4, 128, 16
    gen = torch.Generator(device=dev).manual_seed(b + length)
    st = _k2_weights(gen, dev, n_layer, e, w8)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    kc = rnd(n_layer, b, s, e).to(torch.bfloat16)
    vc = rnd(n_layer, b, s, e).to(torch.bfloat16)
    x = rnd(b, e).to(torch.bfloat16)
    kc_r, vc_r = kc.clone(), vc.clone()
    xo, kc_k, vc_k = _k2_twice(x, st, kc, vc, length, n_head=h)
    xr, _, _ = k2.fused_decode_blocks_ref(x, st, kc_r, vc_r, length,
                                          n_head=h)
    scale = float(xr.float().abs().max())
    assert _err(xo, xr) <= 2e-2 * scale
    for got, want in ((kc_k, kc_r), (vc_k, vc_r)):
        assert _err(got[:, :, length], want[:, :, length]) <= 2e-2 * float(
            want[:, :, length].float().abs().max())
    others = [r for r in range(s) if r != length]
    assert torch.equal(kc_k[:, :, others], kc[:, :, others])
    assert torch.equal(vc_k[:, :, others], vc[:, :, others])


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("b,length", [(8, 5), (40, 0), (3, 15), (300, 9)])
def test_k2_int8_kv_matches_twin(dev, w8, b, length):
    """int8 caches: x within K2's tolerance; the codes written at ``length``
    within one code of the twin's (the twin's f32 K/V differ from the
    kernel's in summation order, so a value near a .5 boundary may round
    the other way); every other row untouched; two launches bitwise
    equal."""
    n_layer, h, e, s = 2, 2, 128, 16
    gen = torch.Generator(device=dev).manual_seed(100 + b + length)
    st = _k2_weights(gen, dev, n_layer, e, w8)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    kc, ks = k2.quantize_cache_side(rnd(n_layer, b, s, e))
    vc, vs = k2.quantize_cache_side(rnd(n_layer, b, s, e))
    x = rnd(b, e).to(torch.bfloat16)
    kc_r, vc_r = kc.clone(), vc.clone()
    xo, kc_k, vc_k = _k2_twice(x, st, kc, vc, length, ks, vs, n_head=h)
    xr, _, _ = k2.fused_decode_blocks_ref(x, st, kc_r, vc_r, length, ks, vs,
                                          n_head=h)
    assert _err(xo, xr) <= 2e-2 * float(xr.float().abs().max())
    for got, want in ((kc_k, kc_r), (vc_k, vc_r)):
        assert _err(got[:, :, length], want[:, :, length]) <= 1
    others = [r for r in range(s) if r != length]
    assert torch.equal(kc_k[:, :, others], kc[:, :, others])
    assert torch.equal(vc_k[:, :, others], vc[:, :, others])


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("b,int8", [(160, True), (8, False)])
def test_k2_full_width_matches_twin(dev, w8, b, int8):
    """GPT-2 124M's width (E=768, 12 heads, S=64) at two layers, as the beam
    path (B*W=160, int8 KV) and the B=8 request (bf16 KV) run it: x within
    K2's tolerance, new rows within it (bf16) or one code (int8), other
    rows untouched, two launches bitwise equal."""
    n_layer, h, e, s, length = 2, 12, 768, 64, 33
    gen = torch.Generator(device=dev).manual_seed(200 + b)
    st = _k2_weights(gen, dev, n_layer, e, w8)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    if int8:
        kc, ks = k2.quantize_cache_side(rnd(n_layer, b, s, e))
        vc, vs = k2.quantize_cache_side(rnd(n_layer, b, s, e))
    else:
        kc, vc = (rnd(n_layer, b, s, e).to(torch.bfloat16) for _ in range(2))
        ks = vs = None
    x = rnd(b, e).to(torch.bfloat16)
    kc_r, vc_r = kc.clone(), vc.clone()
    xo, kc_k, vc_k = _k2_twice(x, st, kc, vc, length, ks, vs, n_head=h)
    xr, _, _ = k2.fused_decode_blocks_ref(x, st, kc_r, vc_r, length, ks, vs,
                                          n_head=h)
    assert _err(xo, xr) <= 2e-2 * float(xr.float().abs().max())
    for got, want in ((kc_k, kc_r), (vc_k, vc_r)):
        row = want[:, :, length]
        tol = 1 if int8 else 2e-2 * float(row.float().abs().max())
        assert _err(got[:, :, length], row) <= tol
    others = [r for r in range(s) if r != length]
    assert torch.equal(kc_k[:, :, others], kc[:, :, others])
    assert torch.equal(vc_k[:, :, others], vc[:, :, others])


@pytest.mark.parametrize("length", [0, 33, 56])
@pytest.mark.parametrize("b,int8", [(128, False), (160, True)])
def test_k2_serving_batches_match_twin(dev, b, int8, length):
    """The serving cells' steps at GPT-2 124M's width, two layers: w8a16 at
    B=128 with a bf16 cache (top-k) and at B*W=160 with an int8 cache
    (beams), whose products run 4 or 5 N chunks of items: x within K2's
    tolerance, new rows within it (bf16) or one code (int8), other rows
    untouched, two launches bitwise equal, each counted as a multi-chunk
    launch."""
    n_layer, h, e, s = 2, 12, 768, 64
    gen = torch.Generator(device=dev).manual_seed(300 + b + length)
    st = _k2_weights(gen, dev, n_layer, e, True)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    if int8:
        kc, ks = k2.quantize_cache_side(rnd(n_layer, b, s, e))
        vc, vs = k2.quantize_cache_side(rnd(n_layer, b, s, e))
    else:
        kc, vc = (rnd(n_layer, b, s, e).to(torch.bfloat16) for _ in range(2))
        ks = vs = None
    x = rnd(b, e).to(torch.bfloat16)
    kc_r, vc_r = kc.clone(), vc.clone()
    before = k2.launches_multi_chunk
    xo, kc_k, vc_k = _k2_twice(x, st, kc, vc, length, ks, vs, n_head=h)
    assert k2.launches_multi_chunk == before + 2
    xr, _, _ = k2.fused_decode_blocks_ref(x, st, kc_r, vc_r, length, ks, vs,
                                          n_head=h)
    assert _err(xo, xr) <= 2e-2 * float(xr.float().abs().max())
    for got, want in ((kc_k, kc_r), (vc_k, vc_r)):
        row = want[:, :, length]
        tol = 1 if int8 else 2e-2 * float(row.float().abs().max())
        assert _err(got[:, :, length], row) <= tol
    others = [r for r in range(s) if r != length]
    assert torch.equal(kc_k[:, :, others], kc[:, :, others])
    assert torch.equal(vc_k[:, :, others], vc[:, :, others])


def test_k2_counts_multi_chunk_launches(dev):
    """``launches_multi_chunk`` counts the calls whose batch spans more than
    one N chunk (B=33 at 32-row chunks), not a B=8 or a B=32 call."""
    n_layer, h, e, s = 1, 2, 128, 8
    gen = torch.Generator(device=dev).manual_seed(33)
    st = _k2_weights(gen, dev, n_layer, e, True)
    counts = []
    for b in (8, 32, 33):
        kc = torch.zeros(n_layer, b, s, e, dtype=torch.bfloat16, device=dev)
        x = torch.randn(b, e, generator=gen, device=dev).to(torch.bfloat16)
        before = (k2.launches, k2.launches_multi_chunk)
        k2.fused_decode_blocks(x, st, kc, kc.clone(), 3, n_head=h)
        counts.append((k2.launches - before[0],
                       k2.launches_multi_chunk - before[1]))
    torch.cuda.synchronize()
    assert counts == [(1, 0), (1, 0), (1, 1)]


@pytest.mark.parametrize("knobs", [dict(n_chunk=16), dict(n_chunk=8),
                                   dict(ring=1), dict(items=528),
                                   dict(items=1), dict(ctas_per_sm=1)])
def test_k2_knobs_keep_the_result(dev, monkeypatch, knobs):
    """Other launch knobs (N chunks of 16 and 8 rows, the smallest ring,
    more and fewer depth splits, one CTA an SM) move the schedule, not the
    math: x within
    K2's tolerance of the twin, two launches bitwise equal."""
    monkeypatch.setattr(k2, "TUNING", dict(k2.TUNING, **knobs))
    n_layer, h, e, s, b, length = 2, 4, 256, 16, 40, 7
    gen = torch.Generator(device=dev).manual_seed(7)
    st = _k2_weights(gen, dev, n_layer, e, True)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    kc, ks = k2.quantize_cache_side(rnd(n_layer, b, s, e))
    vc, vs = k2.quantize_cache_side(rnd(n_layer, b, s, e))
    x = rnd(b, e).to(torch.bfloat16)
    xo, _, _ = _k2_twice(x, st, kc, vc, length, ks, vs, n_head=h)
    xr, _, _ = k2.fused_decode_blocks_ref(x, st, kc.clone(), vc.clone(),
                                          length, ks, vs, n_head=h)
    assert _err(xo, xr) <= 2e-2 * float(xr.float().abs().max())


@pytest.mark.parametrize("int8", [False, True])
def test_k2_long_cache_keeps_the_scores_in_global_memory(dev, int8):
    """A cache whose score rows do not fit in shared memory beside the
    smallest ring (S=12000 at head_dim 64): the scores go to the global
    workspace, and x and the new rows still hold to the twin."""
    n_layer, h, e, s, b, length = 1, 2, 128, 12000, 2, 11000
    assert k2.launch_info(n_layer, b, s, e, h, False, int8)[
        "scores_in_smem"] == 0
    gen = torch.Generator(device=dev).manual_seed(12)
    st = _k2_weights(gen, dev, n_layer, e, False)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    if int8:
        kc, ks = k2.quantize_cache_side(rnd(n_layer, b, s, e))
        vc, vs = k2.quantize_cache_side(rnd(n_layer, b, s, e))
    else:
        kc, vc = (rnd(n_layer, b, s, e).to(torch.bfloat16) for _ in range(2))
        ks = vs = None
    x = rnd(b, e).to(torch.bfloat16)
    kc_r, vc_r = kc.clone(), vc.clone()
    xo, kc_k, vc_k = _k2_twice(x, st, kc, vc, length, ks, vs, n_head=h)
    xr, _, _ = k2.fused_decode_blocks_ref(x, st, kc_r, vc_r, length, ks, vs,
                                          n_head=h)
    assert _err(xo, xr) <= 2e-2 * float(xr.float().abs().max())
    for got, want in ((kc_k, kc_r), (vc_k, vc_r)):
        row = want[:, :, length]
        tol = 1 if int8 else 2e-2 * float(row.float().abs().max())
        assert _err(got[:, :, length], row) <= tol


def test_k2_launch_info(dev):
    """The launch the kernel reports: a cooperative grid of whole SMs, a
    ring, the depth splits of the planner (every
    product's splits divide its K / 128 stages)."""
    info = k2.launch_info(12, 160, 64, 768, 12, True, True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert info["grid"] % sms == 0 and info["grid"] >= sms
    assert info["ring"] >= 1 and info["ctas_per_sm"] >= 1
    for n, k in zip(info["splits"], (768, 768, 768, 3072)):
        assert (k // 128) % n == 0


@pytest.mark.parametrize("w8", [False, True])
def test_k2_int8_kv_rounds_half_to_even(dev, w8):
    """With qkv_w = 0 the new rows are the qkv bias exactly: the kernel's
    codes equal clamp(round-half-to-even(bias / scale)), ties included."""
    n_layer, h, e, s, b = 2, 2, 128, 16, 8
    st = _k2_weights(torch.Generator(device=dev).manual_seed(5), dev,
                     n_layer, e, w8)
    st["qkv_w"] = torch.zeros_like(st["qkv_w"])
    t = torch.tensor([0.5, 1.5, 2.5, -0.5, -3.5, 126.5, 127.5, -200.0,
                      3.25] * 15, device=dev)[:e].repeat(n_layer, 1)
    scale = torch.full((n_layer, 1, e), 0.125, device=dev)
    st["qkv_b"][:, e:2 * e] = t * 0.125
    st["qkv_b"][:, 2 * e:] = -t * 0.125
    kc = torch.zeros(n_layer, b, s, e, dtype=torch.int8, device=dev)
    vc = torch.zeros_like(kc)
    x = torch.ones(b, e, dtype=torch.bfloat16, device=dev)
    k2.fused_decode_blocks(x, st, kc, vc, 4, scale, scale, n_head=h)
    want = torch.clamp(torch.round(t), -127, 127).to(torch.int8)
    assert torch.equal(kc[:, :, 4], want[:, None].expand(n_layer, b, e))
    assert torch.equal(vc[:, :, 4], -want[:, None].expand(n_layer, b, e))


def test_k2_int8_kv_refuses_what_it_does_not_take(dev):
    st = _k2_weights(torch.Generator(device=dev).manual_seed(0), dev, 1, 128,
                     False)
    kc = torch.zeros(1, 2, 8, 128, dtype=torch.int8, device=dev)
    scales = torch.ones(1, 1, 128, device=dev)
    x = torch.zeros(2, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        k2.fused_decode_blocks(x, st, kc, kc.clone(), 1, scales, scales,
                               n_head=16)          # head_dim 8
    with pytest.raises(ValueError, match="k_scale"):
        k2.fused_decode_blocks(x, st, kc, kc.clone(), 1, scales[..., :64],
                               scales, n_head=2)


@pytest.mark.parametrize("w,bw,s,dtype", [(5, 40, 16, torch.bfloat16),
                                          (4, 16, 8, torch.float32),
                                          (5, 40, 16, torch.int8),
                                          (1, 3, 8, torch.bfloat16),
                                          (16, 32, 8, torch.int8)])
def test_k3_matches_twin(dev, w, bw, s, dtype):
    """In place and bitwise equal to the twin, both sides in one launch."""
    gen = torch.Generator(device=dev).manual_seed(w * bw)
    shape = (2, bw, s, 128)
    if dtype == torch.int8:
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
    else:
        k, v = (torch.randn(*shape, generator=gen, device=dev).to(dtype)
                for _ in range(2))
    parent = torch.randint(0, w, (bw,), generator=gen, device=dev)
    want_k = k3.beam_reorder_ref(k, parent, w=w)
    want_v = k3.beam_reorder_ref(v, parent, w=w)
    before = k3.launches
    k_out, v_out = k3.beam_reorder(k, v, parent, w=w)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    assert k_out is k and v_out is v
    assert torch.equal(k, want_k) and torch.equal(v, want_v)


def test_k3_refuses_what_it_does_not_take(dev):
    k = torch.zeros(1, 34, 8, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="w <= 16"):
        k3.beam_reorder(k, k.clone(), torch.zeros(34, device=dev), w=17)
    with pytest.raises(ValueError, match="w <= 16"):
        k3.beam_reorder(k, k.clone(), torch.zeros(34, device=dev), w=5)


def _route_case(dev, n, d, e, k, quantized, seed=0):
    """h [n, d] f32, a bf16 gate [e, d] and bias [e] as the served LFM2
    holds them. ``quantized``: every value a small multiple of a power of
    two, so each score is exact in f32 in any summation order (the kernel
    and cuBLAS then agree bitwise), and experts 1 and e - 1 given the gate
    rows and biases of 0 and e / 2, so s + bias ties on every row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if quantized:
        ints = lambda shape, hi: torch.randint(-hi, hi + 1, shape,
                                               generator=g, device=dev)
        h = ints((n, d), 4).float() / 4
        gate = (ints((e, d), 4).float() / 256).to(torch.bfloat16)
        bias = (ints((e,), 2).float() / 64).to(torch.bfloat16)
        for lo, hi in ((0, 1), (e // 2, e - 1)):
            gate[hi], bias[hi] = gate[lo], bias[lo]
    else:
        h = torch.randn(n, d, generator=g, device=dev)
        gate = (torch.randn(e, d, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        bias = (torch.randn(e, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
    return h, gate, bias


@pytest.mark.parametrize("case", ["random", "quantized", "nonfinite"])
@pytest.mark.parametrize("n,d,e,k", [(160, 2048, 32, 4),
                                     (5280, 2048, 32, 4),
                                     (1, 64, 8, 2), (163, 64, 8, 2),
                                     (500, 256, 64, 8), (1000, 256, 64, 8),
                                     (202, 128, 20, 3)])
def test_moe_route_matches_twin(dev, n, d, e, k, case):
    """The route kernel against its twin at the LFM2 cell's decode (160
    rows, scored by clusters of 4 CTAs) and prefill (160 x 33, CTAs over
    runs of rows) shapes and at edge shapes (one CTA for 8 experts,
    clusters of 8 and 4 with 64 and 20 experts, runs of rows for 64
    experts, a ragged last tile). Its offsets, sorted rows and positions
    are the twin's stable sort of its own choices, added to the running
    count, with the arrival count left at 0. Its choices and weights:
    random inputs, the twin's on every row whose top k + 1 picks lie
    apart by more than f32 sums in another order than cuBLAS's can move
    them; quantized inputs (every score exact), the whole twin's, planted
    ties included; ``nonfinite``, quantized with a row of NaN (every pick
    NaN: the first k experts) and a row with an infinite dim (picks of 1,
    0 and NaN), the whole twin's: NaN first, ties to the lower index."""
    h, gate, bias = _route_case(dev, n, d, e, k, case != "random")
    if case == "nonfinite":
        h[0] = float("nan")
        h[-1, 0] = float("inf")
    ends_sum = torch.full((e,), 7, dtype=torch.int64, device=dev)
    arrived = mr.arrival_count(dev)
    before = mr.launches
    r = mr.route(h, gate, bias, k, arrived=arrived, ends_sum=ends_sum)
    torch.cuda.synchronize()
    assert mr.launches == before + 1 and int(arrived) == 0
    ends, rows, pos = mr.sort_ref(r.chosen, e)
    assert torch.equal(r.ends, ends)
    assert torch.equal(r.rows, rows) and torch.equal(r.pos, pos)
    assert torch.equal(ends_sum, ends.long() + 7)
    want = mr.route_ref(h, gate, bias, k)
    pick = mr.scores_ref(h, gate) + bias.float()
    top = pick.sort(-1, descending=True).values[:, :k + 1]
    if case == "random":
        clear = (top[:, :-1] - top[:, 1:]).min(-1).values > 1e-5
        assert float(clear.float().mean()) > 0.9
        assert torch.equal(r.chosen[clear], want.chosen[clear])
        torch.testing.assert_close(r.weights[clear], want.weights[clear],
                                   rtol=1e-5, atol=0)
        return
    assert torch.equal(r.chosen, want.chosen)
    torch.testing.assert_close(r.weights, want.weights, rtol=1e-6, atol=0,
                               equal_nan=True)
    assert torch.equal(r.rows, want.rows) and torch.equal(r.pos, want.pos)
    assert n < 100 or bool((top[:, k - 1] == top[:, k]).any())
    if case == "nonfinite":
        assert r.chosen[0].tolist() == list(range(k))
        assert bool(r.weights[0].isnan().all())


@pytest.mark.parametrize("n", [160, 5280])
def test_moe_combine_matches_twin(dev, n):
    """The combine kernel against its twin (the unsort and a batched
    product) on the route kernel's positions and weights: within one bf16
    rounding (both sum the k products in f32; cuBLAS may order them
    otherwise), and against the sum taken in f64."""
    d, e, k = 2048, 32, 4
    h, gate, bias = _route_case(dev, n, d, e, k, False, seed=1)
    r = mr.route(h, gate, bias, k, arrived=mr.arrival_count(dev))
    g = torch.Generator(device=dev).manual_seed(2)
    y = torch.randn(n * k, d, generator=g, device=dev).to(torch.bfloat16)
    before = mr.combine_launches
    got = mr.combine(y, r.weights, r.pos)
    torch.cuda.synchronize()
    assert mr.combine_launches == before + 1 and got.dtype == torch.bfloat16
    want = mr.combine_ref(y, r.weights, r.pos)
    terms = (r.weights.to(torch.bfloat16).double()[:, :, None]
             * y.double()[r.pos.long()])
    exact, size = terms.sum(1), terms.abs().sum(1)
    # one rounding to bf16, beside f32 sums of k terms taken in any order
    room = (torch.maximum(got.double().abs(), want.double().abs()) * 2 ** -7
            + size * 2.0 ** -21)
    assert bool(((got.double() - want.double()).abs() <= room).all())
    assert bool(((got.double() - exact).abs() <= room).all())


def test_moe_route_refuses_what_it_does_not_take(dev):
    h, gate, bias = _route_case(dev, 16, 64, 8, 2, False)
    arrived = mr.arrival_count(dev)
    with pytest.raises(ValueError, match="h: need"):
        mr.route(h.to(torch.bfloat16), gate, bias, 2, arrived=arrived)
    with pytest.raises(ValueError, match="gate: need"):
        mr.route(h, gate.float(), bias, 2, arrived=arrived)
    with pytest.raises(ValueError, match="bias: need"):
        mr.route(h, gate, bias.float(), 2, arrived=arrived)
    with pytest.raises(ValueError, match="arrived: need"):
        mr.route(h, gate, bias, 2)
    with pytest.raises(ValueError, match="E <= 64"):
        mr.route(h, gate.repeat(9, 1), None, 2, arrived=arrived)
    with pytest.raises(ValueError, match="D % 8"):
        mr.route(h[:, :60].contiguous(), gate[:, :60].contiguous(), bias, 2,
                 arrived=arrived)
    with pytest.raises(ValueError, match="k <= min"):
        mr.route(h, gate, bias, 9, arrived=arrived)
    r = mr.route(h, gate, bias, 2, arrived=arrived)
    y = torch.zeros(32, 64, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        mr.combine(y, r.weights, r.pos)
    with pytest.raises(ValueError, match="pos: need"):
        mr.combine(y.bfloat16(), r.weights, r.pos.long())


K5_TOL = 2e-2   # relative to max |twin|: bf16 roundings, other f32 order


def _k5_case(dev, seed, n_layers, b, s, e, h, kv, f, w8, int8):
    """bf16 x and weights (or w8a16), f32 norms, a bf16 or int8 cache."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    d = e // h
    st = {k: 1.0 + 0.1 * rnd(n_layers, e) for k in ("norm1_w", "norm2_w")}
    for key, shape in (("wq", (e, e)), ("wk", (e, kv * d)),
                       ("wv", (e, kv * d)), ("wo", (e, e)), ("wg", (e, f)),
                       ("wu", (e, f)), ("wd", (f, e))):
        st[key] = (0.05 * rnd(n_layers, *shape)).to(torch.bfloat16)
    if w8:
        st = k5.quantize_weights(st)
    if int8:
        kc, ks = k2.quantize_cache_side(rnd(n_layers, b, s, kv * d))
        vc, vs = k2.quantize_cache_side(rnd(n_layers, b, s, kv * d))
    else:
        kc, vc = (rnd(n_layers, b, s, kv * d).to(torch.bfloat16)
                  for _ in range(2))
        ks = vs = None
    return rnd(b, e).to(torch.bfloat16), st, kc, vc, ks, vs


@pytest.mark.parametrize("w8,int8", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("b,length,e,h,kv", [(8, 5, 256, 4, 2),
                                             (40, 0, 256, 4, 2),
                                             (3, 33, 256, 4, 4),
                                             (5, 17, 512, 4, 1),
                                             (2, 9, 128, 4, 2)])
def test_k5_matches_twin(dev, w8, int8, b, length, e, h, kv):
    """x within K5_TOL of max |twin|; the rows written at ``length`` within
    K5_TOL of the twin's (bf16) or one code (int8: the twin's f32 K/V may
    sit on the other side of a .5); every other row untouched; two launches
    bitwise equal. Head dims 64, 128 and 32; 1, 2 and 4 query heads per
    KV head; an empty cache and a batch that does not fill a tile."""
    n_layers, s, f = 2, 48, 256
    x, st, kc, vc, ks, vs = _k5_case(dev, b * 100 + length, n_layers, b, s,
                                     e, h, kv, f, w8, int8)
    table = rope.build_rope_cache(e // h, s, device=dev)
    cos_e, sin_e = rope.folded_tables(table, h)
    cos, sin = cos_e[length:length + 1], sin_e[length:length + 1]
    kw = dict(n_heads=h, n_kv_heads=kv, eps=1e-5)
    outs = []
    before = (k5.launches, k5.launches_int8_kv)
    for _ in range(2):
        kc_k, vc_k = kc.clone(), vc.clone()
        xo, _, _ = k5.fused_llama_decode_blocks(x, st, kc_k, vc_k, length,
                                                cos, sin, ks, vs, **kw)
        outs.append((xo, kc_k, vc_k))
    torch.cuda.synchronize()
    assert (k5.launches, k5.launches_int8_kv) == (before[0] + 2,
                                                  before[1] + 2 * int8)
    assert all(torch.equal(a, c) for a, c in zip(*outs))
    xo, kc_k, vc_k = outs[0]
    kc_r, vc_r = kc.clone(), vc.clone()
    xr, _, _ = k5.fused_llama_decode_blocks_ref(x, st, kc_r, vc_r, length,
                                                cos, sin, ks, vs, **kw)
    assert _err(xo, xr) <= K5_TOL * float(xr.float().abs().max())
    for got, want in ((kc_k, kc_r), (vc_k, vc_r)):
        row = want[:, :, length]
        tol = 1 if int8 else K5_TOL * float(row.float().abs().max())
        assert _err(got[:, :, length], row) <= tol
    others = [r for r in range(s) if r != length]
    assert torch.equal(kc_k[:, :, others], kc[:, :, others])
    assert torch.equal(vc_k[:, :, others], vc[:, :, others])


@pytest.mark.parametrize("w8,int8", [(False, False), (True, False),
                                     (False, True), (True, True)])
def test_k5_1b_width_matches_twin(dev, w8, int8):
    """The 1B-class width (E=2048, 16 heads on 8 KV heads, F=5632) at two
    layers, B=8: x within K5_TOL, new rows within it (bf16) or one code
    (int8), other rows untouched, two launches bitwise equal."""
    n_layers, b, s, e, h, kv, f, length = 2, 8, 48, 2048, 16, 8, 5632, 40
    x, st, kc, vc, ks, vs = _k5_case(dev, 11, n_layers, b, s, e, h, kv, f,
                                     w8, int8)
    cos_e, sin_e = rope.folded_tables(rope.build_rope_cache(e // h, s,
                                                            device=dev), h)
    cos, sin = cos_e[length:length + 1], sin_e[length:length + 1]
    kw = dict(n_heads=h, n_kv_heads=kv, eps=1e-5)
    outs = []
    for _ in range(2):
        kc_k, vc_k = kc.clone(), vc.clone()
        xo, _, _ = k5.fused_llama_decode_blocks(x, st, kc_k, vc_k, length,
                                                cos, sin, ks, vs, **kw)
        outs.append((xo, kc_k, vc_k))
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(*outs))
    xo, kc_k, vc_k = outs[0]
    kc_r, vc_r = kc.clone(), vc.clone()
    xr, _, _ = k5.fused_llama_decode_blocks_ref(x, st, kc_r, vc_r, length,
                                                cos, sin, ks, vs, **kw)
    assert _err(xo, xr) <= K5_TOL * float(xr.float().abs().max())
    for got, want in ((kc_k, kc_r), (vc_k, vc_r)):
        row = want[:, :, length]
        tol = 1 if int8 else K5_TOL * float(row.float().abs().max())
        assert _err(got[:, :, length], row) <= tol
    others = [r for r in range(s) if r != length]
    assert torch.equal(kc_k[:, :, others], kc[:, :, others])
    assert torch.equal(vc_k[:, :, others], vc[:, :, others])


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("items", [8, 1056])
def test_k5_both_act_paths_match_twin(dev, monkeypatch, w8, items):
    """The gate|up product folds SwiGLU into its epilogue (a small item
    target: each item takes a gate and an up tile) or splits its depth and
    leaves SwiGLU to an act phase (a large one); both hold x to K5_TOL and
    two launches bitwise."""
    monkeypatch.setattr(k2, "TUNING", dict(k2.TUNING, items=items))
    n_layers, b, s, e, h, kv, f, length = 2, 40, 16, 256, 4, 2, 512, 9
    x, st, kc, vc, ks, vs = _k5_case(dev, 17, n_layers, b, s, e, h, kv, f,
                                     w8, True)
    assert k5.launch_info(n_layers, b, s, e, h, kv, f, w8, True)[
        "fold_act"] == int(items == 8)
    cos_e, sin_e = rope.folded_tables(rope.build_rope_cache(e // h, s,
                                                            device=dev), h)
    cos, sin = cos_e[length:length + 1], sin_e[length:length + 1]
    kw = dict(n_heads=h, n_kv_heads=kv, eps=1e-5)
    outs = [k5.fused_llama_decode_blocks(x, st, kc.clone(), vc.clone(),
                                         length, cos, sin, ks, vs, **kw)[0]
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    xr, _, _ = k5.fused_llama_decode_blocks_ref(x, st, kc.clone(), vc.clone(),
                                                length, cos, sin, ks, vs,
                                                **kw)
    assert _err(outs[0], xr) <= K5_TOL * float(xr.float().abs().max())


def test_k5_refuses_what_it_does_not_take(dev):
    x, st, kc, vc, ks, vs = _k5_case(dev, 0, 1, 2, 16, 256, 32, 16, 256,
                                     False, True)
    cos = torch.zeros(1, 256, device=dev)
    kw = dict(n_kv_heads=16, eps=1e-5)
    with pytest.raises(ValueError, match="multiple of 16"):
        k5.fused_llama_decode_blocks(x, st, kc, vc, 1, cos, cos, ks, vs,
                                     n_heads=32, **kw)      # head_dim 8
    x, st, kc, vc, ks, vs = _k5_case(dev, 0, 1, 2, 16, 256, 4, 2, 256,
                                     False, False)
    with pytest.raises(ValueError, match="length"):
        k5.fused_llama_decode_blocks(x, st, kc, vc, 16, cos, cos, n_heads=4,
                                     n_kv_heads=2, eps=1e-5)
    with pytest.raises(ValueError, match="H % KV"):
        k5.fused_llama_decode_blocks(x, st, kc, vc, 1, cos, cos, n_heads=4,
                                     n_kv_heads=3, eps=1e-5)
    with pytest.raises(ValueError, match="cos_row"):
        k5.fused_llama_decode_blocks(x, st, kc, vc, 1, cos.double(), cos,
                                     n_heads=4, n_kv_heads=2, eps=1e-5)


def test_k5_gate_counts_shared_memory_as_the_kernel_does(dev):
    """``supported``'s shared-memory count is the library's own."""
    from frankenstein_tpu_torch.ops.cuda import build
    lib = build.library()
    for d, r, s, nbytes in ((64, 2, 64, 1), (128, 4, 48, 2), (32, 1, 1000, 1)):
        assert k5.attention_smem_bytes(d, r, s, nbytes) == \
            lib.fk_fused_llama_decode_smem_bytes(d, r, s, nbytes)


FLASH_TOL = 2e-2   # relative to max |twin|: p, ds, dq, dk, dv round to bf16


def _flash_case(dev, mode, b, t, h, d, p, seed, dout=None, shuffled=False):
    """bf16 q, k, v, dout and the slab ids (sorted kept positions of a
    4x longer window, or unsorted ones) of one mode."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, t, h * d, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    if dout is None:
        dout = torch.randn(b, t, h * d, generator=gen,
                           device=dev).to(torch.bfloat16)
    sid = None
    if mode == "positions":
        noise = torch.rand(b, 4 * t, generator=gen, device=dev)
        pos = torch.argsort(noise, dim=-1)[:, :t]
        pos = pos if shuffled else pos.sort(dim=-1).values
        sid = (pos // p).to(torch.int32).contiguous()
    kw = dict(n_heads=h, mode=mode, tok_per_time=p, slab_ids=sid)
    return (q, k, v, dout), kw


FLASH_CASES = [("dense", 1, 256, 2, 32, 0, False),
               ("dense", 2, 384, 3, 64, 0, False),
               ("slab", 1, 256, 2, 32, 64, False),
               ("slab", 2, 384, 3, 32, 100, False),
               ("slab", 1, 256, 2, 64, 16, False),
               ("positions", 2, 512, 2, 32, 256, False),
               ("positions", 1, 384, 3, 64, 40, False),
               ("positions", 2, 256, 2, 32, 16, True)]


@pytest.mark.parametrize("mode,b,t,h,d,p,shuffled", FLASH_CASES)
def test_k6_k7_match_twin_and_are_deterministic(dev, mode, b, t, h, d, p,
                                                shuffled):
    """Forward (out, lse) and backward (dq, dk, dv) in bf16 against the
    twins in f32 on the same bf16 inputs and the kernel's out and lse; two
    backward launches bitwise equal."""
    (q, k, v, dout), kw = _flash_case(dev, mode, b, t, h, d, p,
                                      seed=b * t + p, shuffled=shuffled)
    before = (k67.launches[mode], k67.launches_bwd[mode])
    out, lse = k67.flash_attention(q, k, v, **kw)
    got = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert (k67.launches[mode], k67.launches_bwd[mode]) == (
        before[0] + 1, before[1] + 2)
    ref, ref_lse = k67.flash_attention_ref(q.float(), k.float(), v.float(),
                                           **kw)
    assert _err(out, ref) <= FLASH_TOL * float(ref.abs().max())
    assert _err(lse, ref_lse) <= FLASH_TOL * float(ref_lse.abs().max())
    want = k67.flash_attention_bwd_ref(
        *(x.float() for x in (q, k, v, out)), lse, dout.float(), **kw)
    for name, g, a, w in zip("qkv", got, again, want):
        assert torch.equal(g, a), name
        assert _err(g, w) <= FLASH_TOL * float(w.abs().max()), name


@pytest.mark.parametrize("mode,p", [("dense", 0), ("slab", 100),
                                    ("positions", 64)])
def test_k6_k7_probability_rows_sum_to_one(dev, mode, p):
    """dout one-hot on (query i_c, lane c): column c of dv is row i_c of
    the probabilities the backward recomputes from the forward's lse."""
    b, t, h, d = 2, 512, 2, 32
    rows = torch.arange(d, device=dev) * 13 % t
    dout = torch.zeros(b, t, h * d, dtype=torch.bfloat16, device=dev)
    for head in range(h):
        dout[:, rows, head * d + torch.arange(d, device=dev)] = 1.0
    (q, k, v, _), kw = _flash_case(dev, mode, b, t, h, d, p, seed=9,
                                   dout=dout)
    out, lse = k67.flash_attention(q, k, v, **kw)
    _, _, dv = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    sums = dv.float().reshape(b, t, h, d).sum(dim=1)
    assert float((sums - 1.0).abs().max()) < 1e-2


# K7 dense's wgmma kernels (csrc/flash_attention_dense.cu): forward key
# tiles of 128, backward tiles of 64, 4-stage rings, 132 SMs.
DENSE_CASES = [(1, 640, 2, 32, 1.0),    # 5 key tiles: the ring wraps unevenly
               (1, 1024, 2, 64, 1.0),   # D=64, 128-byte swizzle
               (2, 2304, 4, 32, 1.0),   # 144 CTAs: more than one wave
               (2, 512, 2, 32, 8.0)]    # q, k x8: maxes move by hundreds


@pytest.mark.parametrize("b,t,h,d,mag", DENSE_CASES)
def test_k7_dense_matches_twin_and_is_deterministic(dev, b, t, h, d, mag):
    """The wgmma forward (out, lse) and backward (dq, dk, dv) against the
    twins in f32 on the same bf16 inputs, finite, two backward launches
    bitwise equal."""
    (q, k, v, dout), kw = _flash_case(dev, "dense", b, t, h, d, 0,
                                      seed=t + d)
    q, k = ((x.float() * mag).to(torch.bfloat16) for x in (q, k))
    out, lse = k67.flash_attention(q, k, v, **kw)
    got = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in (out, lse, *got))
    ref, ref_lse = k67.flash_attention_ref(q.float(), k.float(), v.float(),
                                           **kw)
    assert _err(out, ref) <= FLASH_TOL * float(ref.abs().max())
    assert _err(lse, ref_lse) <= FLASH_TOL * float(ref_lse.abs().max())
    want = k67.flash_attention_bwd_ref(
        *(x.float() for x in (q, k, v, out)), lse, dout.float(), **kw)
    for name, g, a, w in zip("qkv", got, again, want):
        assert torch.equal(g, a), name
        assert _err(g, w) <= FLASH_TOL * float(w.abs().max()), name


@pytest.mark.parametrize("t,d", [(640, 32), (1024, 64)])
def test_k7_dense_probability_rows_sum_to_one(dev, t, d):
    """As test_k6_k7_probability_rows_sum_to_one, for the wgmma kernels at
    a ring that wraps unevenly and at D=64."""
    b, h = 2, 2
    rows = torch.arange(d, device=dev) * 13 % t
    dout = torch.zeros(b, t, h * d, dtype=torch.bfloat16, device=dev)
    for head in range(h):
        dout[:, rows, head * d + torch.arange(d, device=dev)] = 1.0
    (q, k, v, _), kw = _flash_case(dev, "dense", b, t, h, d, 0, seed=9,
                                   dout=dout)
    out, lse = k67.flash_attention(q, k, v, **kw)
    _, _, dv = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    sums = dv.float().reshape(b, t, h, d).sum(dim=1)
    assert float((sums - 1.0).abs().max()) < 1e-2


def test_k6_k7_occupancy_reads_every_pass(dev):
    """Registers and resident CTAs of every mode's three passes at both
    head dims; the dense forward at D=32 keeps two CTAs an SM, the shape
    its 64-key tiles were chosen for."""
    for mode in k67.MODES:
        for pass_ in k67.PASSES:
            for d in (32, 64):
                regs, ctas = k67.occupancy(mode, pass_, d)
                assert 0 < regs <= 255 and ctas >= 1, (mode, pass_, d)
    assert k67.occupancy("dense", "fwd", 32)[1] == 2


# K6's wgmma kernels (csrc/flash_attention_dense.cu, mode positions): the
# staircase each CTA takes from the slab ids, exact in any order.
K6_CASES = [(2, 1536, 8, 32, 256, "sorted"),   # the MAE encoder's shape
            (1, 768, 2, 64, 40, "shuffled"),   # D=64: 128-key forward tiles
            (2, 512, 2, 32, 16, "first tile unseen"),
            (1, 512, 2, 64, 16, "first tile unseen"),
            (2, 640, 2, 32, 64, "sorted"),     # 10 key tiles: the ring wraps
                                               # unevenly; the dq pass's
                                               # last 192-row block ends
                                               # past T
            (1, 640, 3, 32, 40, "shuffled")]


def _k6_case(dev, b, t, h, d, p, order, seed, dout=None):
    """bf16 q, k, v, dout and the wrapper's keywords of mode positions.
    ``order``: "sorted" or "shuffled" kept positions of a 4x longer window
    (``_flash_case``), or "first tile unseen": slab ids in [0, 4) with the
    first 128 keys (a forward key tile at either head dim) at the greatest,
    so that most rows' first visited tile holds no key they see."""
    if order != "first tile unseen":
        return _flash_case(dev, "positions", b, t, h, d, p, seed, dout=dout,
                           shuffled=order == "shuffled")
    (q, k, v, dout), kw = _flash_case(dev, "dense", b, t, h, d, 0, seed,
                                      dout=dout)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    sid = torch.randint(0, 4, (b, t), generator=gen, device=dev,
                        dtype=torch.int32)
    sid[:, :128] = 3
    kw.update(mode="positions", tok_per_time=p, slab_ids=sid.contiguous())
    return (q, k, v, dout), kw


@pytest.mark.parametrize("b,t,h,d,p,order", K6_CASES)
def test_k6_matches_twin_and_is_deterministic(dev, b, t, h, d, p, order):
    """The wgmma forward (out, lse) and backward (dq, dk, dv) of mode
    positions against the twins in f32 on the same bf16 inputs, finite,
    one launch a call, two backward launches bitwise equal."""
    (q, k, v, dout), kw = _k6_case(dev, b, t, h, d, p, order, seed=t + d)
    before = (k67.launches["positions"], k67.launches_bwd["positions"])
    out, lse = k67.flash_attention(q, k, v, **kw)
    got = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert (k67.launches["positions"], k67.launches_bwd["positions"]) == (
        before[0] + 1, before[1] + 2)
    assert all(bool(torch.isfinite(x).all()) for x in (out, lse, *got))
    ref, ref_lse = k67.flash_attention_ref(q.float(), k.float(), v.float(),
                                           **kw)
    assert _err(out, ref) <= FLASH_TOL * float(ref.abs().max())
    assert _err(lse, ref_lse) <= FLASH_TOL * float(ref_lse.abs().max())
    want = k67.flash_attention_bwd_ref(
        *(x.float() for x in (q, k, v, out)), lse, dout.float(), **kw)
    for name, g, a, w in zip("qkv", got, again, want):
        assert torch.equal(g, a), name
        assert _err(g, w) <= FLASH_TOL * float(w.abs().max()), name


@pytest.mark.parametrize("t,d,p,order", [(1536, 32, 256, "sorted"),
                                         (512, 32, 16, "first tile unseen"),
                                         (768, 64, 40, "shuffled")])
def test_k6_probability_rows_sum_to_one(dev, t, d, p, order):
    """As test_k6_k7_probability_rows_sum_to_one, for K6's wgmma passes at
    the MAE's shape, where rows meet a wholly unseen tile first, and at
    D=64."""
    b, h = 2, 2
    rows = torch.arange(d, device=dev) * 13 % t
    dout = torch.zeros(b, t, h * d, dtype=torch.bfloat16, device=dev)
    for head in range(h):
        dout[:, rows, head * d + torch.arange(d, device=dev)] = 1.0
    (q, k, v, _), kw = _k6_case(dev, b, t, h, d, p, order, seed=9,
                                dout=dout)
    out, lse = k67.flash_attention(q, k, v, **kw)
    _, _, dv = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    sums = dv.float().reshape(b, t, h, d).sum(dim=1)
    assert float((sums - 1.0).abs().max()) < 1e-2


def test_k6_occupancy_reads_every_pass(dev):
    """Registers and resident CTAs of K6's three wgmma passes at both head
    dims (at the MAE's N=1536); its forward at D=32 keeps K7 dense's two
    CTAs an SM."""
    for pass_ in k67.PASSES:
        for d in (32, 64):
            regs, ctas = k67.occupancy("positions", pass_, d)
            assert 0 < regs <= 255 and ctas >= 1, (pass_, d)
    assert k67.occupancy("positions", "fwd", 32)[1] == 2


# K7 slab's wgmma passes (csrc/flash_attention_dense.cu, mode slab): the
# unmasked instance where P % 64 == 0 (and P % 128 == 0 for the forward's
# 128-key tiles at D=64), the MASKED one at any other P, a P below one
# tile and P=1 (every warpgroup's diagonal tile partly visible).
SLAB_CASES = [(2, 768, 2, 32, 256), (1, 768, 2, 64, 256),
              (2, 768, 2, 32, 96), (1, 768, 2, 64, 96),
              (1, 512, 2, 32, 8), (1, 512, 2, 64, 8),
              (1, 384, 2, 32, 1), (1, 640, 3, 32, 64),
              (1, 1024, 2, 64, 64)]


@pytest.mark.parametrize("b,t,h,d,p", SLAB_CASES)
def test_k7_slab_matches_twin_and_is_deterministic(dev, b, t, h, d, p):
    """Forward (out, lse) and backward (dq, dk, dv) against the twins in f32
    on the same bf16 inputs, finite, two backward launches bitwise equal,
    the probability rows the backward recomputes summing to 1."""
    (q, k, v, dout), kw = _flash_case(dev, "slab", b, t, h, d, p,
                                      seed=7 * t + p + d)
    out, lse = k67.flash_attention(q, k, v, **kw)
    got = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = k67.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    rows = torch.arange(d, device=dev) * 13 % t
    onehot = torch.zeros_like(dout)
    for head in range(h):
        onehot[:, rows, head * d + torch.arange(d, device=dev)] = 1.0
    _, _, dv1 = k67.flash_attention_bwd(q, k, v, out, lse, onehot, **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in (out, lse, *got))
    ref, ref_lse = k67.flash_attention_ref(q.float(), k.float(), v.float(),
                                           **kw)
    assert _err(out, ref) <= FLASH_TOL * float(ref.abs().max())
    assert _err(lse, ref_lse) <= FLASH_TOL * float(ref_lse.abs().max())
    want = k67.flash_attention_bwd_ref(
        *(x.float() for x in (q, k, v, out)), lse, dout.float(), **kw)
    for name, g, a, w in zip("qkv", got, again, want):
        assert torch.equal(g, a), name
        assert _err(g, w) <= FLASH_TOL * float(w.abs().max()), name
    sums = dv1.float().reshape(b, t, h, d).sum(dim=1)
    assert float((sums - 1.0).abs().max()) < 1e-2


def test_k7_slab_occupancy_reads_every_pass(dev):
    """Registers and resident CTAs of both instances of K7 slab's three
    passes at both head dims: K7 dense's shapes, whose forward at D=32
    keeps two CTAs an SM."""
    for pass_ in k67.PASSES:
        for d in (32, 64):
            for masked in (False, True):
                regs, ctas = k67.occupancy("slab", pass_, d, masked)
                assert 0 < regs <= 255 and ctas >= 1, (pass_, d, masked)
    assert k67.occupancy("slab", "fwd", 32)[1] == 2
    assert k67.occupancy("slab", "fwd", 32, True)[1] == 2


def test_k6_k7_refuse_what_they_do_not_take(dev):
    x = torch.zeros(1, 200, 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="T % 128"):
        k67.flash_attention(x, x, x, n_heads=2, mode="dense")
    x = torch.zeros(1, 256, 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        k67.flash_attention(x.float(), x, x, n_heads=2, mode="dense")
    with pytest.raises(ValueError, match="head_dim"):
        k67.flash_attention(x, x, x, n_heads=4, mode="dense")
    with pytest.raises(ValueError, match="slab_ids"):
        k67.flash_attention(x, x, x, n_heads=2, mode="positions",
                            slab_ids=torch.zeros(1, 256, dtype=torch.int64,
                                                 device=dev))
    lse = torch.zeros(1, 2, 128, device=dev)
    with pytest.raises(ValueError, match="lse"):
        k67.flash_attention_bwd(x, x, x, x, lse, x, n_heads=2, mode="dense")


def test_mae_gradients_match_twin(dev):
    """An MAE of 2048 tokens (512 kept) on the card in bf16: its encoder
    attention runs K6 and its decoder attention K7, forward and backward,
    and every parameter's gradient matches the f32 CPU twin's given the
    same mask indices."""
    from frankenstein_tpu_torch.config import MAEConfig
    from frankenstein_tpu_torch.models.brainformer import MAE, masking_indices
    from frankenstein_tpu_torch.models.weights import init_mae_
    cfg = MAEConfig(window_size=64, n_electrodes=256, patch_size=8, dim=64,
                    n_layers=1, head_dim=32, hidden_dim=128, n_heads=2,
                    n_dec_layers=1, decoder_dim=64)
    ref = init_mae_(MAE(cfg), seed=0)                       # f32, CPU
    card = MAE(cfg, device=dev, dtype=torch.bfloat16)       # f32 params
    card.load_state_dict(ref.state_dict())
    x = torch.randn(2, 64, 256, generator=torch.Generator().manual_seed(1))
    idx = masking_indices(torch.Generator().manual_seed(2), 2,
                          cfg.block_size, cfg.masking_ratio)
    ref(x, indices=idx)[0].backward()
    before = (dict(k67.launches), dict(k67.launches_bwd))
    card(x.to(dev).to(torch.bfloat16),
         indices=tuple(i.to(dev) for i in idx))[0].backward()
    torch.cuda.synchronize()
    runs = {m: (k67.launches[m] - before[0][m],
                k67.launches_bwd[m] - before[1][m]) for m in k67.MODES}
    assert runs == {"dense": (1, 1), "slab": (0, 0), "positions": (1, 1)}
    for (name, pr), pc in zip(ref.named_parameters(), card.parameters()):
        rel = float((pc.grad.cpu() - pr.grad).norm() / pr.grad.norm())
        assert rel < 5e-2, (name, rel)


K9_TOL = 2e-2   # relative to max |twin|: a, b and g round to bf16 after f32
                # sums taken in another order, so a value may round the
                # other way


def _k9_case(dev, b, t, e, hidden, kind, seed):
    """bf16 x [B, T, E]; f32 norm parameters (no bias for RMSNorm) and f32
    nn.Linear weights, which the wrapper casts to bf16."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    x = rnd(b, t, e).to(torch.bfloat16)
    nw = 1.0 + 0.1 * rnd(e)
    nb = 0.1 * rnd(e) if kind == "layernorm" else None
    return (x, nw, nb, rnd(hidden, e) / e ** 0.5, rnd(hidden, e) / e ** 0.5,
            rnd(e, hidden) / hidden ** 0.5)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("b,t,e,hidden", [(2, 256, 256, 1024),
                                          (4, 32, 256, 512),
                                          (1, 200, 128, 256),
                                          (2, 77, 64, 192),
                                          (1, 130, 192, 320),
                                          (1, 100, 128, 64),
                                          (3, 6000, 256, 1024),
                                          (1, 17000, 64, 128),
                                          (2, 8500, 192, 256),
                                          (1, 16950, 128, 576)])
def test_k9_matches_twin_and_is_deterministic(dev, kind, b, t, e, hidden):
    """Out and the update out - x against the twin at the kernel's rounding
    points, on the same bf16 inputs; two launches bitwise equal. Every
    width, hidden from the gate's 64 up, row counts that leave the last row
    tile (and the last CTA of a cluster) empty or ragged, and both
    instances of each width: one warpgroup a CTA at the small row counts,
    two from about 66 * 128 rows on."""
    args = _k9_case(dev, b, t, e, hidden, kind, seed=b * t + e)
    before = k9.launches
    out = k9.fused_norm_swiglu(*args, kind=kind)
    again = k9.fused_norm_swiglu(*args, kind=kind)
    torch.cuda.synchronize()
    assert k9.launches == before + 2
    assert torch.equal(out, again)
    ref = k9.fused_norm_swiglu_ref(*args, kind=kind)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert _err(out, ref) <= K9_TOL * float(ref.float().abs().max())
    x = args[0].float()
    upd = ref.float() - x
    assert _err(out.float() - x, upd) <= K9_TOL * float(upd.abs().max())


def test_k9_occupancy_reads_every_instance(dev):
    """Registers and resident CTAs of every instance (width, norm, one or
    two warpgroups), from the CUDA runtime; a launch's own pick at a small
    and a large row count; a width without an instance is refused."""
    for e in (64, 128, 192, 256):
        for kind in k9.KINDS:
            for nwg in (1, 2):
                regs, ctas = k9.occupancy(e, kind, nwg)
                assert 0 < regs <= 255 and ctas >= 1, (e, kind, nwg, regs)
    assert k9.occupancy(256, rows=128 * 32) == k9.occupancy(256,
                                                            warpgroups=1)
    assert k9.occupancy(256, rows=2 * 6144) == k9.occupancy(256,
                                                            warpgroups=2)
    with pytest.raises(RuntimeError, match="occupancy"):
        k9.occupancy(96, warpgroups=1)


def test_k9_refuses_what_it_does_not_take(dev):
    x, nw, nb, w1, w3, w2 = _k9_case(dev, 1, 16, 256, 512, "layernorm", 0)
    with pytest.raises(ValueError, match="bfloat16"):
        k9.fused_norm_swiglu(x.float(), nw, nb, w1, w3, w2)
    with pytest.raises(ValueError, match="multiples of 64"):
        k9.fused_norm_swiglu(x[..., :96], nw[:96], nb[:96], w1[:, :96],
                             w3[:, :96], w2[:96])
    with pytest.raises(ValueError, match="multiples of 64"):
        k9.fused_norm_swiglu(x, nw, nb, w1[:100], w3[:100], w2[:, :100])
    wide = _k9_case(dev, 1, 16, 320, 512, "layernorm", 1)
    with pytest.raises(ValueError, match="E <= 256"):
        k9.fused_norm_swiglu(*wide)
    with pytest.raises(ValueError, match="contiguous"):
        k9.fused_norm_swiglu(x[:, ::2], nw, nb, w1, w3, w2)
    with pytest.raises(ValueError, match="no bias"):
        k9.fused_norm_swiglu(x, nw, nb, w1, w3, w2, kind="rmsnorm")


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_k9_block_matches_module_chain(dev, monkeypatch, norm):
    """A bf16 Block on the card: its MLP sublayer through K9 against the
    module chain (``fused_mlp.ENABLED`` off), forward within K9_TOL, and
    every gradient equal bitwise, since K9's backward is that chain's
    autograd; under remat K9 runs again in the backward."""
    from frankenstein_tpu_torch.models.layers import Block, run_block
    torch.manual_seed(2)
    block = Block(256, 8, 32, 1024, device=dev, dtype=torch.bfloat16,
                  norm=norm)
    x = torch.randn(2, 256, 256, device=dev).to(torch.bfloat16)
    dy = torch.randn(2, 256, 256, device=dev).to(torch.bfloat16)
    leaves = [x.requires_grad_(), *block.parameters()]

    def run(remat=False):
        before = k9.launches
        out = run_block(block, x, remat=remat)
        grads = torch.autograd.grad(out, leaves, dy)
        torch.cuda.synchronize()
        return out.detach(), grads, k9.launches - before

    out, grads, n = run()
    _, grads_remat, n_remat = run(remat=True)
    monkeypatch.setattr(k9, "ENABLED", False)
    want, want_grads, n_chain = run()
    assert (n, n_remat, n_chain) == (1, 2, 0)
    assert _err(out, want) <= K9_TOL * float(want.float().abs().max())
    for g, r, w in zip(grads, grads_remat, want_grads):
        assert torch.equal(g, w) and torch.equal(r, w)


def _launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    counts = {"K1": k1.launches, "K4": k1.launches_bwd, "K2": k2.launches,
              "K3": k3.launches, "K5": k5.launches, "K9": k9.launches}
    for mode in k67.MODES:
        counts[f"fwd {mode}"] = k67.launches[mode]
        counts[f"bwd {mode}"] = k67.launches_bwd[mode]
    return counts


# A Franky and an MAE whose every kernel takes their bf16 inputs: head_dim
# 32, width 64 with hidden 128; Franky's encoder over 1024 tokens (4 slabs
# of 256), the MAE's decoder over 2048, the length from which dense
# attention runs K7 (512 of them kept for its encoder)
CARD_FRANKY_YAML = """\
model: franky
model_config:
  brain:
    encoder: {window_size: 768, n_electrodes: 256, patch_size: 192, dim: 64,
              n_layers: 1, head_dim: 32, hidden_dim: 128, n_heads: 2,
              n_kv_heads: 2, n_dec_layers: 1, decoder_dim: 64}
    n_output_tokens: 4
    output_dim: 128
    dim: 64
    n_layers: 1
    head_dim: 32
    hidden_dim: 128
    n_heads: 2
    n_kv_heads: 2
  gpt: {block_size: 64, vocab_size: 50304, n_layer: 1, n_head: 2,
        n_embd: 128}
train: {batch_size: 1, max_steps: 1, eval_interval: 1, warmup_iters: 0,
        use_scheduler: false, log_interval: 1}
"""
CARD_MAE_YAML = """\
model: mae
model_config: {window_size: 768, n_electrodes: 256, patch_size: 96,
               dim: 64, n_layers: 1, head_dim: 32, hidden_dim: 128,
               n_heads: 2, n_kv_heads: 2, n_dec_layers: 1, decoder_dim: 64}
train: {batch_size: 1, max_steps: 1, eval_interval: 1, warmup_iters: 0,
        use_scheduler: false, log_interval: 1}
"""


def _train_one_step(tmp_path, name, *args):
    """One step (and one eval) through the train CLI in-process: (the
    launches it made, its finite losses)."""
    import json
    from frankenstein_tpu_torch.train import __main__ as train_cli
    before = _launch_counts()
    train_cli.main([*args, "--data", "synthetic", "--synthetic-trials", "8",
                    "--exp-name", name, "--save-folder", str(tmp_path)])
    torch.cuda.synchronize()
    after = _launch_counts()
    records = [json.loads(line) for line in
               (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
    losses = [r[k] for r in records for k in ("train/loss", "val/loss")
              if k in r]
    assert losses and all(map(math.isfinite, losses)), losses
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("model", ["franky", "mae"])
def test_f32_training_step_runs_the_plain_routes(dev, tmp_path, model):
    """--no-bf16 computes in f32, which no kernel takes: a B=1 step runs
    the plain routes and launches nothing; the same step in bf16 launches
    the kernels (K1, K4 and K9 for Franky; K6, K7 and K9 for the MAE)."""
    cfg = tmp_path / f"{model}.yaml"
    cfg.write_text(CARD_FRANKY_YAML if model == "franky" else CARD_MAE_YAML)
    assert _train_one_step(tmp_path, "f32", "--config", str(cfg),
                           "--no-bf16") == {}
    bf16 = _train_one_step(tmp_path, "bf16", "--config", str(cfg))
    want = ({"K1", "K4", "K9"} if model == "franky" else
            {"K9", "fwd positions", "bwd positions", "fwd dense",
             "bwd dense"})
    assert set(bf16) == want, bf16


def test_mae_of_100_channels_runs_plain_attention(dev, tmp_path):
    """--channels 100: 2400 tokens, 600 kept, which K6 and K7 do not take
    (T % 128); the encoder's MLPs still run K9 (width 256, hidden 1024),
    the decoder's (an f32 residual stream) the module chain."""
    got = _train_one_step(tmp_path, "mae100", "--model", "mae",
                          "--channels", "100", "--batch-size", "1",
                          "--steps", "1", "--eval-interval", "1")
    # 4 encoder blocks; one training forward and 8 eval forwards (the 8
    # validation trials at B=1)
    assert got == {"K9": 4 * 9}, got


# K8: the bf16 kernels against the twin on the same bf16 inputs. h rounds
# to bf16 on both sides after f32 statistics summed in other orders, so a
# rare lane rounds the other way: logits agree to about 1e-3.
K8_TOL = 3e-3
K8_E = 768


def _k8_case(dev, b, v, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    return (rnd(b, K8_E).to(torch.bfloat16), 1.0 + 0.1 * rnd(K8_E),
            0.1 * rnd(K8_E), (0.05 * rnd(v, K8_E)).to(torch.bfloat16))


def _k8_agrees(got, want, logits, k: int) -> None:
    """Values and logz within K8_TOL; each chosen index distinct and, where
    it differs from the twin's, a token whose twin logit is within K8_TOL
    of the twin's value at that rank (a near-tie)."""
    (vals, idx, logz), (rv, ri, rz) = got, want
    assert vals.shape == rv.shape and idx.dtype == torch.int64
    assert _err(vals, rv) <= K8_TOL and _err(logz, rz) <= K8_TOL
    assert all(len(set(row.tolist())) == k for row in idx)
    picked = torch.gather(logits, 1, idx)
    near = (picked - rv).abs()[idx != ri]
    assert near.numel() == 0 or float(near.max()) <= K8_TOL


@pytest.mark.parametrize("v", [50304, 50257])
@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("b", [1, 8, 128, 160])
def test_k8_matches_twin_and_is_deterministic(dev, b, k, v):
    """GPT-2 width (E=768) with the full vocab and a ragged last slab
    (50257); two launches bitwise equal."""
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8
    args = _k8_case(dev, b, v, seed=b * k + v)
    before = k8.launches
    got = k8.lm_head_topk(*args, k=k)
    again = k8.lm_head_topk(*args, k=k)
    torch.cuda.synchronize()
    assert k8.launches == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = k8.lm_head_topk_ref(*args, k=k)
    _k8_agrees(got, want, k8.head_logits_ref(*args), k)
    assert int(got[1].max()) < v


@pytest.mark.parametrize("b,e,v,k", [(8, 1024, 50257, 10),
                                     (300, 768, 1000, 10),
                                     (3, 1600, 20000, 32),
                                     (40, 768, 333, 5)])
def test_k8_other_shapes_match_twin(dev, b, e, v, k):
    """A width past GPT-2's 768 (streamed E), a batch past the widest
    instance (two chunks of 256), a grid of under one CTA an SM (V=1000:
    8 vocab blocks) and a ragged tail three rows into its block."""
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8
    gen = torch.Generator(device=dev).manual_seed(b + e + v)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    args = (rnd(b, e).to(torch.bfloat16), 1.0 + 0.1 * rnd(e), 0.1 * rnd(e),
            (0.05 * rnd(v, e)).to(torch.bfloat16))
    got = k8.lm_head_topk(*args, k=k)
    again = k8.lm_head_topk(*args, k=k)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    _k8_agrees(got, k8.lm_head_topk_ref(*args, k=k),
               k8.head_logits_ref(*args), k)


def test_k8_top_k_in_the_vocab_tail(dev):
    """V=50257: the last block holds 81 rows. Batch row 7's top-10 are rows
    50245-50254 of the tail; every logit of batch row 1 is negative, so the
    table's rows past V, zeros on the card, would outrank them all were they
    not masked out of the top-k and of logz."""
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8
    x, ln_w, ln_b, wte = _k8_case(dev, 8, 50257, seed=5)
    ln_w.fill_(1.0)
    ln_b.fill_(0.0)
    xf = x[7].float()
    a = (xf - xf.mean()) / xf.std(unbiased=False)    # row 7's h
    gen = torch.Generator(device=dev).manual_seed(6)
    r = torch.randn(K8_E, generator=gen, device=dev)
    r = r - r.mean()
    r = r - (r @ a) / (a @ a) * a
    bvec = r / r.std(unbiased=False)                  # row 1's h, _|_ a
    x[1] = bvec.to(torch.bfloat16)
    noise = torch.randn(50257, K8_E, generator=gen, device=dev)
    wte.copy_((-0.01 * bvec + 0.001 * noise).to(torch.bfloat16))
    scale = torch.linspace(0.5, 0.25, 12, device=dev)[:, None]
    wte[50245:] = (scale * (a - 0.02 * bvec)).to(torch.bfloat16)
    got = k8.lm_head_topk(x, ln_w, ln_b, wte, k=10)
    want = k8.lm_head_topk_ref(x, ln_w, ln_b, wte, k=10)
    logits = k8.head_logits_ref(x, ln_w, ln_b, wte)
    assert float(logits[1].max()) < 0
    _k8_agrees(got, want, logits, 10)
    assert got[1][7].tolist() == list(range(50245, 50255))
    assert got[1][1].tolist() == list(range(50256, 50246, -1))
    assert int(got[1].max()) < 50257


def test_k8_launch_and_scratch_are_kept(dev):
    """The launch the wrapper plans is the kernel's (batch width, stages,
    shared memory), one CTA an SM, no spills; a repeated call reuses the
    scratch and the f32 copies of bf16 norm parameters, and a parameter
    changed in place is copied anew."""
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8
    grid = k8.grid_size(dev, 50304)
    for b in k8.WIDTHS + (300,):
        for k in (1, 10, 32):
            info = k8.info(b, k, grid)
            plan = k8._plan(b, k, grid)
            assert (info["width"], info["stages"], info["smem"]) == plan
            assert info["ctas"] >= 1 and info["local_bytes"] == 0, info
    x, ln_w, ln_b, wte = _k8_case(dev, 8, 50304, seed=2)
    ln_w, ln_b = ln_w.to(torch.bfloat16), ln_b.to(torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    first = k8.lm_head_topk(x, ln_w, ln_b, wte, k=10)
    scratch = k8._scratch(dev, 8, K8_E, 10, grid, stream)
    w32 = k8._as_f32(ln_w, K8_E, dev)
    second = k8.lm_head_topk(x, ln_w, ln_b, wte, k=10)
    assert all(a is b for a, b in zip(
        scratch, k8._scratch(dev, 8, K8_E, 10, grid, stream)))
    assert k8._as_f32(ln_w, K8_E, dev) is w32
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    ln_w.mul_(2.0)
    assert k8._as_f32(ln_w, K8_E, dev) is not w32
    third = k8.lm_head_topk(x, ln_w, ln_b, wte, k=10)
    _k8_agrees(third, k8.lm_head_topk_ref(x, ln_w.float(), ln_b.float(), wte,
                                          k=10),
               k8.head_logits_ref(x, ln_w.float(), ln_b.float(), wte), 10)


def test_k8_breaks_ties_to_the_lower_index(dev):
    """Vocab rows 3 and 7 equal and aligned with row 0's h: row 0's top
    two are (3, 7), equal values, in that order, on both sides."""
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8
    x, ln_w, ln_b, wte = _k8_case(dev, 8, 50304, seed=3)
    xf = x[:1].float()
    h0 = (xf - xf.mean()) / xf.std(unbiased=False)
    wte[3] = wte[7] = (0.2 * h0[0]).to(torch.bfloat16)
    for vals, idx, _ in (k8.lm_head_topk(x, ln_w, ln_b, wte, k=4),
                         k8.lm_head_topk_ref(x, ln_w, ln_b, wte, k=4)):
        assert idx[0, :2].tolist() == [3, 7]
        assert float(vals[0, 0]) == float(vals[0, 1])


def test_k8_refuses_what_it_does_not_take(dev):
    from frankenstein_tpu_torch.ops.cuda import lm_head_topk as k8
    bf16, f32 = torch.bfloat16, torch.float32
    assert k8.supported(dev, bf16, bf16, 128, 768, 50304, 10)
    assert k8.supported(dev, bf16, bf16, 3, 768, 50257, 32)
    assert not k8.supported(dev, f32, bf16, 128, 768, 50304, 10)
    assert not k8.supported(dev, bf16, f32, 128, 768, 50304, 10)
    assert not k8.supported(dev, bf16, bf16, 128, 768, 50304, 33)
    assert not k8.supported(dev, bf16, bf16, 128, 772, 50304, 10)
    assert k8.supported(dev, bf16, bf16, 128, 1024, 50304, 10)
    x, ln_w, ln_b, wte = _k8_case(dev, 4, 1000, seed=1)
    with pytest.raises(ValueError, match="K8 takes"):
        k8.lm_head_topk(x.float(), ln_w, ln_b, wte, k=10)
    with pytest.raises(ValueError, match="K8 takes"):
        k8.lm_head_topk(x, ln_w, ln_b, wte, k=33)


# K10: the int8 QK scores are the twin's exactly (integer dots, the same
# dequantization order). out rounds to bf16 (2^-9 relative) and p to bf16
# before AV: out within K10_OUT_TOL of max |twin|; lse differs only by the
# order of f32 sums: within K10_LSE_TOL. K1's output, and a kernel that read
# chunk 0's K scale for every tile, fail that check.
K10_CASES = [(1, 1024, 2, 32, 256), (2, 6144, 8, 32, 256),
             (1, 2048, 2, 64, 100), (1, 2048, 2, 32, 96),
             (1, 3072, 2, 64, 256), (2, 1024, 4, 32, 1024),
             (1, 2048, 2, 32, 160), (1, 2048, 3, 64, 192)]
K10_OUT_TOL = 1e-2
K10_LSE_TOL = 1e-4


def _k10_passes(out, lse, ref, ref_lse) -> bool:
    return (_err(out, ref) <= K10_OUT_TOL * float(ref.abs().max())
            and _err(lse, ref_lse) <= K10_LSE_TOL)


def _k10_case(dev, b, t, h, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, t, h * d, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    cos, sin = rope.folded_tables(rope.build_rope_cache(d, t + 3,
                                                        device=dev)[-t:], 1)
    return q, k, v, cos, sin


@pytest.mark.parametrize("b,t,h,d,p", K10_CASES)
def test_k10_matches_twin_and_is_deterministic(dev, b, t, h, d, p):
    """K and Q codes and scales of the pre-passes equal to the twins'
    (codes off .5 ties); out and lse within K10_OUT_TOL and K10_LSE_TOL of
    the twin run on the same bf16 inputs, where K1's output (and, with two
    key chunks or more, chunk 0's K scale read for every tile) fails; two
    launches bitwise equal. Both head dims in the unmasked (P % 64 == 0)
    and masked instances, and P = T."""
    q, k, v, cos, sin = _k10_case(dev, b, t, h, d, seed=b * t + p)
    kw = dict(n_heads=h, tok_per_time=p)
    k8, ks = k1.rope_quantize_k(k, cos, sin, n_heads=h)
    r8, rs = k1.rope_quantize_k_ref(k, cos, sin, n_heads=h)
    assert torch.equal(ks, rs)
    rotated = rope.apply_rope_folded(k, cos.repeat(1, h), sin.repeat(1, h))
    scale = rs.transpose(1, 2).repeat_interleave(1024, dim=1)   # [B, T, H]
    pre = rotated.float().reshape(b, t, h, d) / scale[..., None]
    tie = (((pre.abs() % 1.0) - 0.5).abs() <= 1e-3).reshape(b, t, h * d)
    assert int(((k8 != r8) & ~tie).sum()) == 0
    q8, qs = k1.rope_quantize_q(q, cos, sin, n_heads=h)
    w8, ws = k1.rope_quantize_q_ref(q, cos, sin, n_heads=h)
    assert torch.equal(qs, ws)
    rotated = rope.apply_rope_folded(q, cos.repeat(1, h), sin.repeat(1, h))
    pre = (rotated.float().reshape(b, t, h, d)
           / ws.transpose(1, 2)[..., None])
    tie = (((pre.abs() % 1.0) - 0.5).abs() <= 1e-3).reshape(b, t, h * d)
    assert int(((q8 != w8) & ~tie).sum()) == 0
    before = (k1.launches, k1.launches_int8)
    out, lse = k1.slab_rope_attention(q, k, v, cos, sin, qk_int8=True, **kw)
    again = k1.slab_rope_attention(q, k, v, cos, sin, qk_int8=True, **kw)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_int8) == (before[0], before[1] + 2)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = k1.slab_rope_attention_int8_ref(q, k, v, cos, sin, **kw)
    assert _k10_passes(out, lse, ref, ref_lse)
    exact, exact_lse = k1.slab_rope_attention(q, k, v, cos, sin, **kw)
    assert 0.0 < _err(out, exact) < 5e-2
    assert not _k10_passes(exact, exact_lse, ref, ref_lse)
    if t >= 2048:
        chunk0 = ks[..., :1].expand_as(ks).contiguous()
        wrong = k1.slab_rope_attention_fwd_int8(q, k8, chunk0, v, cos, sin,
                                                **kw)
        assert not _k10_passes(*wrong, ref, ref_lse)


def test_k10_refuses_what_it_does_not_take(dev):
    bf16 = torch.bfloat16
    assert k1.supported(dev, bf16, 6144, 256, 8, True)
    assert not k1.supported(dev, bf16, 6272, 256, 8, True)
    assert not k1.supported(dev, torch.float32, 6144, 256, 8, True)
    q, k, v, cos, sin = _k10_case(dev, 1, 1152, 2, 32, seed=0)
    with pytest.raises(ValueError, match="1024"):
        k1.slab_rope_attention(q, k, v, cos, sin, n_heads=2, tok_per_time=64,
                               qk_int8=True)
    with pytest.raises(ValueError, match="1024"):
        k1.rope_quantize_k(k, cos, sin, n_heads=2)


# The probe modes of K1's and K10's wgmma forwards (ops/cuda/slab_probe.py)
# against their twins on the same bf16 inputs, within the limits slab_probe
# states (EXACT_TOL, DEFINED_TOL, LSE_TOL; ``probe_error``, ``agrees``).
PROBE_EXACT = ("kernel", "mask_all", "exp2", "int8_full")
PROBE_DEFINED = ("dots_only", "no_mask", "int8_dots_only",
                 "int8_cheap_dequant", "int8_noquant")
PROBE_CASES = [(2, 2048, 2, p) for p in (8, 100, 256)] + [(1, 6144, 8, 256)]


def _probe_case(dev, b, t, h, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, t, h * 32, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(3)]


@pytest.mark.parametrize("variant", PROBE_EXACT + PROBE_DEFINED)
@pytest.mark.parametrize("b,t,h,p", PROBE_CASES)
def test_probe_modes_match_twins_and_are_deterministic(dev, variant, b, t, h,
                                                       p):
    from frankenstein_tpu_torch.ops.cuda import slab_probe as sp
    q, k, v = _probe_case(dev, b, t, h, seed=b * t + p)
    kw = dict(n_heads=h, tok_per_time=p, variant=variant)
    counter = "launches_int8" if sp.is_int8(variant) else "launches"
    before = getattr(sp, counter)
    out, lse = sp.slab_attention_probe(q, k, v, **kw)
    again = sp.slab_attention_probe(q, k, v, **kw)
    torch.cuda.synchronize()
    assert getattr(sp, counter) == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = sp.TWINS[variant](q, k, v, n_heads=h, tok_per_time=p)
    err = sp.probe_error(variant, out, lse, ref, ref_lse)
    assert sp.agrees(variant, err), err


@pytest.mark.parametrize("p", [8, 256])
def test_probe_kernel_is_k1_and_k10_on_identity_tables(dev, p):
    """With cos 1, sin 0 tables K1's pre-pass leaves q and k as they are,
    and K1's forward is the ``kernel`` mode's instance: K1's out and lse
    are bitwise the mode's, and both within K1's 3e-2 of the mode's twin.
    So run, K10 is bitwise ``int8_full`` (its pre-passes rotate by the
    identity, then the same forward), both within K10's tolerances of
    K10's twin; the K and Q pre-passes give bitwise equal codes and
    scales; ``int8_full``'s forward alone on ``probe_quantize_q`` /
    ``_k``'s codes is bitwise the pair."""
    from frankenstein_tpu_torch.ops.cuda import slab_probe as sp
    b, t, h = 2, 2048, 2
    q, k, v = _probe_case(dev, b, t, h, seed=p)
    cos = torch.ones(t, 32, device=dev)
    sin = torch.zeros(t, 32, device=dev)
    kw = dict(n_heads=h, tok_per_time=p)
    mode = sp.slab_attention_probe(q, k, v, variant="kernel", **kw)
    got = k1.slab_rope_attention(q, k, v, cos, sin, **kw)
    assert torch.equal(got[0], mode[0]) and torch.equal(got[1], mode[1])
    want = sp.TWINS["kernel"](q, k, v, **kw)
    assert _err(got[0], want[0]) < 3e-2 and _err(got[1], want[1]) < 3e-2
    got = sp.slab_attention_probe(q, k, v, variant="int8_full", **kw)
    prod = k1.slab_rope_attention(q, k, v, cos, sin, qk_int8=True, **kw)
    assert torch.equal(got[0], prod[0]) and torch.equal(got[1], prod[1])
    want = k1.slab_rope_attention_int8_ref(q, k, v, cos, sin, **kw)
    assert _k10_passes(*got, *want) and _k10_passes(*prod, *want)
    k_codes = sp.probe_quantize_k(k, n_heads=h, variant="int8_full")
    q_codes = sp.probe_quantize_q(q, n_heads=h, variant="int8_full")
    for pair, want_pair in ((k_codes, k1.rope_quantize_k(k, cos, sin,
                                                         n_heads=h)),
                            (q_codes, k1.rope_quantize_q(q, cos, sin,
                                                         n_heads=h))):
        assert torch.equal(pair[0], want_pair[0])
        assert torch.equal(pair[1], want_pair[1])
    alone = sp.slab_attention_probe(q_codes, k_codes, v, variant="int8_full",
                                    with_prepass=False, **kw)
    assert torch.equal(alone[0], got[0]) and torch.equal(alone[1], got[1])


def test_probe_no_kbd_guard(dev):
    """``no_kbd`` reads V in the wrong layout (timing only, no twin): its
    values are finite, bitwise repeatable and differ from ``kernel``'s,
    in both mask instances."""
    from frankenstein_tpu_torch.ops.cuda import slab_probe as sp
    q, k, v = _probe_case(dev, 2, 2048, 2, seed=7)
    for p in (8, 256):
        kw = dict(n_heads=2, tok_per_time=p)
        out, lse = sp.slab_attention_probe(q, k, v, variant="no_kbd", **kw)
        again = sp.slab_attention_probe(q, k, v, variant="no_kbd", **kw)
        ref = sp.slab_attention_probe(q, k, v, variant="kernel", **kw)
        torch.cuda.synchronize()
        guard = sp.no_kbd_guard(out, lse, again, ref[0])
        assert sp.guard_holds(guard), (p, guard)


def test_probe_refuses_what_it_does_not_take(dev):
    from frankenstein_tpu_torch.ops.cuda import slab_probe as sp
    q64 = torch.zeros(1, 1024, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="does not take"):   # head_dim 64
        sp.slab_attention_probe(q64, q64, q64, n_heads=2, tok_per_time=8,
                                variant="kernel")
    q = torch.zeros(1, 1152, 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="does not take"):   # T % 1024
        sp.slab_attention_probe(q, q, q, n_heads=2, tok_per_time=8,
                                variant="int8_noquant")
    with pytest.raises(ValueError, match="does not take"):
        sp.slab_attention_probe(q.float(), q.float(), q.float(), n_heads=2,
                                tok_per_time=8, variant="kernel")


def test_probe_occupancy_reads_every_mode(dev):
    """Registers and resident CTAs of each probe mode's D=32 forward
    instance at P=256 and P=8 from the CUDA runtime (``kernel``'s and
    ``int8_full``'s are production K1's and K10's forwards), and production
    K1's and K10's passes from ``fwd_occupancy`` and
    ``fwd_int8_occupancy``; a head dim without a K10 instance is
    refused."""
    from frankenstein_tpu_torch.ops.cuda import slab_probe as sp
    for p in (256, 8):
        for name in sp.PROBE_VARIANTS:
            regs, ctas = sp.occupancy(name, p)
            assert 0 < regs <= 255 and ctas >= 1, (name, p)
        assert sp.occupancy("kernel", p) == k1.fwd_occupancy("fwd", 32, p)
        assert (sp.occupancy("int8_full", p)
                == k1.fwd_int8_occupancy("fwd", 32, p))
    for p in (256, 96):
        for d in (32, 64):
            for pass_ in k1.FWD_PASSES:
                for regs, ctas in (k1.fwd_occupancy(pass_, d, p),
                                   k1.fwd_int8_occupancy(pass_, d, p)):
                    assert 0 < regs <= 255 and ctas >= 1, (pass_, d, p)
    with pytest.raises(RuntimeError, match="occupancy"):
        k1.fwd_int8_occupancy("fwd", 48, 256)
