"""The FrankyLfm2 cell's arithmetic: the model FLOPs of a served request and
the routed experts' bound, from the configuration's published widths (the
card's peaks and ``_bound`` are ``counts.py``'s).

- a token's forward FLOPs count every matrix product once (2 a weight),
  the short convolution's taps, the router and ``num_experts_per_tok``
  experts a token in each routed layer, and 4 ``head_dim`` a query head
  and visible key in each attention layer; the head 2 ``hidden_size`` a
  vocabulary row, on the rows whose logits are used;
- a call of the routed experts over ``rows`` tokens reads every expert
  that got a row once (3 ``hidden_size`` x ``moe_intermediate_size``
  bfloat16 weights), reads each (row, choice) pair's input row and writes
  its output row (bfloat16), and makes 6 ``hidden_size`` x
  ``moe_intermediate_size`` FLOPs a pair. The experts with a row are
  expected from each expert's share of the routed rows (even shares when
  none are given): expert e goes without a row with probability (1 -
  share_e) ** pairs.
"""

from __future__ import annotations

from portbench import counts
from portbench.counts import _bound


def _kinds(lm: dict) -> tuple:
    """(attention layers, conv layers, dense layers, routed layers)."""
    n_attn = sum(t == "full_attention" for t in lm["layer_types"])
    n = lm["num_hidden_layers"]
    return n_attn, n - n_attn, lm["num_dense_layers"], \
        n - lm["num_dense_layers"]


def token_flops(lm: dict, visible: int) -> float:
    """One token through every layer (no head), its attention seeing
    ``visible`` keys, itself included."""
    d = lm["hidden_size"]
    n_q, n_kv = lm["num_attention_heads"], lm["num_key_value_heads"]
    hd = d // n_q
    n_attn, n_conv, n_dense, n_moe = _kinds(lm)
    conv = 2 * d * 3 * d + 2 * d * d + 2 * lm["conv_L_cache"] * d
    attn = (2 * d * n_q * hd + 2 * 2 * d * n_kv * hd + 2 * n_q * hd * d
            + 4 * n_q * hd * visible)
    dense = 2 * 3 * d * lm["intermediate_size"]
    routed = (2 * d * lm["num_experts"] + lm["num_experts_per_tok"] * 2 * 3
              * d * lm["moe_intermediate_size"])
    return float(n_conv * conv + n_attn * attn + n_dense * dense
                 + n_moe * routed)


def head_flops(lm: dict) -> float:
    return 2.0 * lm["hidden_size"] * lm["vocab_size"]


def request_flops(model_config: dict, batch: int, rows: int,
                  new_tokens: int) -> float:
    """Model FLOPs of one served request of ``batch`` windows over ``rows``
    decode rows (``counts.franky_request_flops``' rule): the encode, the
    prefill of the prefix and the start token with the head on its last
    position, and the ``new_tokens - 1`` decode steps that produce the
    tokens after the first."""
    brain, lm = model_config["brain"], model_config["lm"]
    t0 = brain["n_output_tokens"] + 1
    prefill = sum(token_flops(lm, i + 1) for i in range(t0)) + head_flops(lm)
    decode = sum(token_flops(lm, t0 + i + 1) + head_flops(lm)
                 for i in range(new_tokens - 1))
    return (batch * counts.franky_encode_flops(brain)
            + rows * (prefill + decode))


def experts_bound(lm: dict, rows: int, shares=None) -> float:
    """The least seconds one call of the routed experts over ``rows``
    tokens could take on the card (``counts._bound``); ``shares`` each
    expert's share of the routed pairs (None: even)."""
    d, f = lm["hidden_size"], lm["moe_intermediate_size"]
    e, k = lm["num_experts"], lm["num_experts_per_tok"]
    pairs = rows * k
    shares = [1.0 / e] * e if shares is None else shares
    used = sum(1.0 - (1.0 - float(p)) ** pairs for p in shares)
    n_bytes = used * 3 * d * f * 2 + pairs * 2 * d * 2
    return _bound(n_bytes, pairs * 2 * 3 * d * f)


def routed_layers(lm: dict) -> int:
    return _kinds(lm)[3]
