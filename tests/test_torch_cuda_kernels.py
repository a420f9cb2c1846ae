"""Kernels K1 and K2 on the card against their plain PyTorch twins, at small
shapes that reach the kernels' edge cases (slabs that do not divide the
tiles, a batch that does not fill a tile, an empty cache).

The kernels have no CPU mode, so without a CUDA device these tests skip.
On the card: ``python -m pytest tests/test_torch_cuda_kernels.py -q``.
"""

import pytest
import torch

from frankenstein_tpu_torch.ops import rope
from frankenstein_tpu_torch.ops.cuda import fused_decode as k2
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
                                       (2, 512, 2, 32, 512)])
def test_k1_matches_twin(dev, b, t, h, d, p):
    """bf16 kernel vs the twin in f32 on the same bf16 inputs; the kernel
    rounds rotated q/k and the probabilities to bf16, hence 3e-2."""
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


def test_k1_refuses_what_it_does_not_take(dev):
    q = torch.zeros(1, 200, 64, dtype=torch.bfloat16, device=dev)
    cos = torch.zeros(200, 32, device=dev)
    with pytest.raises(ValueError, match="T % 128"):
        k1.slab_rope_attention(q, q, q, cos, cos, n_heads=2, tok_per_time=8)
    with pytest.raises(ValueError, match="bf16"):
        k1.slab_rope_attention(q.float(), q, q, cos, cos, n_heads=2,
                               tok_per_time=8)


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("b,length", [(8, 5), (40, 0), (3, 15)])
def test_k2_matches_twin(dev, w8, b, length):
    n_layer, h, e, s = 2, 4, 128, 16
    gen = torch.Generator(device=dev).manual_seed(b + length)
    rnd = lambda *shape, sc=1.0: torch.randn(*shape, generator=gen,
                                             device=dev) * sc
    st = {key: rnd(n_layer, n, sc=0.05) for key, n in (
        ("ln1_w", e), ("ln1_b", e), ("qkv_b", 3 * e), ("proj_b", e),
        ("ln2_w", e), ("ln2_b", e), ("fc_b", 4 * e), ("fc2_b", e))}
    for key, shape in (("qkv_w", (e, 3 * e)), ("proj_w", (e, e)),
                       ("fc_w", (e, 4 * e)), ("fc2_w", (4 * e, e))):
        st[key] = rnd(n_layer, *shape, sc=0.05).to(torch.bfloat16)
    if w8:
        st = k2.quantize_weights(st)
    kc = rnd(n_layer, b, s, e).to(torch.bfloat16)
    vc = rnd(n_layer, b, s, e).to(torch.bfloat16)
    x = rnd(b, e).to(torch.bfloat16)
    kc_k, vc_k, kc_r, vc_r = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = k2.launches
    xo, _, _ = k2.fused_decode_blocks(x, st, kc_k, vc_k, length, n_head=h)
    assert k2.launches == before + 1
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
