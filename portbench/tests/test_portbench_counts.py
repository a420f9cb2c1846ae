"""The yardstick's copied counts against hand arithmetic at small shapes."""

import pytest

from portbench import counts


def test_slab_pairs_by_hand():
    # 8 tokens in slabs of 4: the first slab's 4 queries see 4 keys, the
    # second's see all 8
    assert counts._slab_pairs(8, 4) == 4 * 4 + 4 * 8
    # a ragged last slab: 6 tokens, slabs of 4 -> 4*4 + 2*6
    assert counts._slab_pairs(6, 4) == 16 + 12
    # one slab is dense
    assert counts._slab_pairs(5, 8) == 25


def test_causal_and_flash_pairs():
    assert counts._causal_pairs(4) == 1 + 2 + 3 + 4
    assert counts._flash_pairs("dense", 2, 3) == 2 * 9
    assert counts._flash_pairs("slab", 2, 8, 4) == 2 * 48
    with pytest.raises(ValueError):
        counts._flash_pairs("causal", 1, 4)


def test_gathered_pairs_keep_all_is_the_slab_mask():
    assert counts.expected_gathered_pairs(8, 8, 4) == pytest.approx(48)
    # one kept token sees only itself
    assert counts.expected_gathered_pairs(8, 1, 4) == pytest.approx(1)


def test_k2_bound_counts_live_rows():
    # 1 layer, E=4, 2 rows at cache length 3: int8 weights and cache
    e, rows, length = 4, 2, 3
    n_bytes = (2 * rows * e * 2 + 12 * e * e + 13 * e * 4 + 9 * e * 4
               + 2 * e * 4 + 2 * rows * (length + 1) * e)
    ops = 2 * rows * 12 * e * e + 4 * rows * e * (length + 1)
    want = max(n_bytes / counts.HBM_BYTES_PER_S, ops / counts.PEAK_BF16_FLOPS)
    got = counts.k2_bound(rows, 1, e, length, int8_weights=True,
                          int8_kv=True)
    assert got == pytest.approx(want)
    # the bytes grow with the live rows, not an allocated cache
    assert counts.k2_bound(rows, 1, e, length + 1, int8_weights=True,
                           int8_kv=True) > got


def test_k7_and_k4_ops_by_hand():
    b, t, h, d, p = 2, 8, 2, 4, 4
    fwd, bwd = counts.k7_dense_bounds(b, t, h, d)
    assert fwd >= 4 * d * h * b * t * t / counts.PEAK_BF16_FLOPS
    assert bwd >= 10 * d * h * b * t * t / counts.PEAK_BF16_FLOPS
    big = 1 << 12      # ops-bound at a long sequence
    f, g = counts.k7_dense_bounds(1, big, 8, 32)
    assert f == pytest.approx(4 * 32 * 8 * big * big / counts.PEAK_BF16_FLOPS)
    assert g == pytest.approx(10 * 32 * 8 * big * big
                              / counts.PEAK_BF16_FLOPS)
    k4 = counts.k4_bound(1, big, 8, 32, 256)
    assert k4 == pytest.approx(10 * 32 * 8 * counts._slab_pairs(big, 256)
                               / counts.PEAK_BF16_FLOPS)
    k1 = counts.k1_bound(1, big, 8, 32, 256)
    assert k1 == pytest.approx(4 * 32 * 8 * counts._slab_pairs(big, 256)
                               / counts.PEAK_BF16_FLOPS)


def test_encode_flops_count_visible_pairs():
    brain = {"encoder": {"window_size": 8, "n_electrodes": 4,
                         "patch_size": 2, "dim": 4, "n_layers": 1,
                         "head_dim": 2, "hidden_dim": 8, "n_heads": 2},
             "n_output_tokens": 2, "output_dim": 6, "dim": 4, "n_layers": 1,
             "head_dim": 2, "hidden_dim": 8, "n_heads": 2}
    n_tok = 16
    enc = brain["encoder"]
    per_tok = 2 * 4 * 3 * 4 + 2 * 4 * 4 + 2 * 4 * 8 * 3
    want_enc = 2 * 2 * 4 * n_tok + n_tok * per_tok + 4 * 4 * \
        counts._slab_pairs(n_tok, enc["n_electrodes"])
    cross = 2 * 4 * 4 * 2 + 2 * 4 * 8 * n_tok + 4 * n_tok * 4 * 2 + \
        2 * 4 * 4 * 2 + 2 * 4 * 8 * 3 * 2
    self_blocks = 2 * per_tok + 4 * 4 * 4
    want = want_enc + cross + self_blocks + 2 * 4 * 6 * 2
    assert counts.franky_encode_flops(brain) == pytest.approx(want)


def test_family_first_match_wins():
    assert counts.family("flash_attn_fwd_positions_wgmma") == "K6 fwd"
    assert counts.family("flash_attn_fwd_dense_wgmma") == "K7 fwd"
    assert counts.family("slab_rope_attn_fwd_int8_wgmma") == "K10"
    assert counts.family("slab_rope_attn_fwd_prep") == "K1"
    assert counts.family("void gpt2_decode_step<signed char>") == "K2"
    assert counts.family("nothing known") == "other"
