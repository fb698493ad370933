"""FLOPs an AFMoE training step needs, from the configuration's shapes.

Needed work only: the forward pass, and the backward's two products for
each forward product (3x the forward in all). A sliding layer's attention
needs the (query, key) pairs inside its window, W(W+1)/2 + (T - W) W of a
sequence of T >= W (T(T+1)/2 below W), a full layer's the causal T(T+1)/2.
The routed experts need their three products on the T k (token, expert)
assignments: the zero rows that pad each expert's group, the remat's
recompute and whatever a kernel computes outside the window are not needed
and are not counted.
"""

from __future__ import annotations

from typing import Any, Dict


def _layers(config: Dict[str, Any]):
    n = int(config["num_hidden_layers"])
    return n, int(config["num_dense_layers"]), list(config["layer_types"])[:n]


def window_pairs(seq_len: int, window: int) -> int:
    """(query, key) pairs of one sequence that a sliding window of ``window``
    keys (the query's own included) lets through."""
    w = min(window, seq_len)
    return w * (w + 1) // 2 + (seq_len - w) * w


def causal_pairs(seq_len: int) -> int:
    return seq_len * (seq_len + 1) // 2


def routed_flops_per_token(config: Dict[str, Any]) -> float:
    """The forward's routed expert products per token, 2 x MACs: top-k
    experts' three products, over every MoE layer."""
    n, dense, _ = _layers(config)
    d, fe = int(config["hidden_size"]), int(config["moe_intermediate_size"])
    return 2.0 * (n - dense) * int(config["num_experts_per_tok"]) * 3 * d * fe


def product_flops_per_token(config: Dict[str, Any]) -> float:
    """The forward's matrix products per token, 2 x MACs: the q/k/v, gate and
    output projections of every layer; the dense layers' FFNs; the MoE
    layers' router, shared experts and routed experts; the LM head."""
    n, dense, _ = _layers(config)
    d, h, kv = (int(config[k]) for k in ("hidden_size", "num_attention_heads",
                                          "num_key_value_heads"))
    dh, ff, fe = (int(config[k]) for k in ("head_dim", "intermediate_size",
                                            "moe_intermediate_size"))
    attn = d * (2 * h * dh + 2 * kv * dh) + h * dh * d
    moe_outside = d * int(config["num_experts"]) + int(config["num_shared_experts"]) * 3 * d * fe
    macs = n * attn + dense * 3 * d * ff + (n - dense) * moe_outside
    return 2.0 * (macs + d * int(config["vocab_size"])) + routed_flops_per_token(config)


def attention_flops_per_sequence(config: Dict[str, Any], seq_len: int) -> float:
    """The forward's two attention products (Q.K^T and P.V) of one sequence,
    over every layer and query head, on the pairs each layer reads."""
    _, _, types = _layers(config)
    h, dh = int(config["num_attention_heads"]), int(config["head_dim"])
    window = int(config["sliding_window"])
    pairs = sum(window_pairs(seq_len, window) if t == "sliding_attention"
                else causal_pairs(seq_len) for t in types)
    return 2.0 * 2.0 * pairs * dh * h


def step_flops(config: Dict[str, Any], seq_len: int, rows: int) -> Dict[str, float]:
    """A training step's needed FLOPs on ``rows`` sequences of ``seq_len``:
    ``products`` (forward and the backward's two per product), of which
    ``routed`` are the routed experts'; ``attention`` (forward's two
    products and the backward's four); and ``total``."""
    tokens = seq_len * rows
    products = 3.0 * product_flops_per_token(config) * tokens
    attention = 3.0 * attention_flops_per_sequence(config, seq_len) * rows
    return {"products": products, "routed": 3.0 * routed_flops_per_token(config) * tokens,
            "attention": attention, "total": products + attention}
