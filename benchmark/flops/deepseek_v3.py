"""FLOPs a DeepSeek-V3 training step needs, from the configuration's shapes.

Needed work only: the forward pass, and the backward's two products for
each forward product (3x the forward in all). Attention is causal: T(T+1)/2
(query, key) pairs a sequence and head, each taking q.k over the q/k width
(qk_nope_head_dim + qk_rope_head_dim) and p.v over v_head_dim in the
forward, and dP = dO.V^T and dV over the v width, dQ and dK over the q/k
width in the backward. The routed experts need their three products on the
T k (token, expert) assignments: the zero rows that pad each expert's
group, the remat's recompute and the backward's recompute of the scores
are not needed and are not counted.
"""

from __future__ import annotations

from typing import Any, Dict


def _sizes(config: Dict[str, Any]):
    n, dense = int(config["num_hidden_layers"]), int(config["first_k_dense_replace"])
    qk = int(config["qk_nope_head_dim"]) + int(config["qk_rope_head_dim"])
    return n, dense, qk, int(config["v_head_dim"]), int(config["num_attention_heads"])


def causal_pairs(seq_len: int) -> int:
    return seq_len * (seq_len + 1) // 2


def routed_flops_per_token(config: Dict[str, Any]) -> float:
    """The forward's routed expert products per token, 2 x MACs: the top-k
    experts' three products, over every MoE layer."""
    n, dense, _, _, _ = _sizes(config)
    d, fe = int(config["hidden_size"]), int(config["moe_intermediate_size"])
    return 2.0 * (n - dense) * int(config["num_experts_per_tok"]) * 3 * d * fe


def product_flops_per_token(config: Dict[str, Any]) -> float:
    """The forward's matrix products per token, 2 x MACs: every layer's q
    projection, latent down-projection (c and k_pe), up-projection (k_nope
    and v) and output projection; the dense layers' FFNs; the MoE layers'
    router, shared experts and routed experts; the LM head."""
    n, dense, qk, dv, h = _sizes(config)
    d, rank = int(config["hidden_size"]), int(config["kv_lora_rank"])
    nope, rope = int(config["qk_nope_head_dim"]), int(config["qk_rope_head_dim"])
    ff, fe = int(config["intermediate_size"]), int(config["moe_intermediate_size"])
    attn = d * h * qk + d * (rank + rope) + rank * h * (nope + dv) + h * dv * d
    moe_outside = d * int(config["n_routed_experts"]) + int(config["n_shared_experts"]) * 3 * d * fe
    macs = n * attn + dense * 3 * d * ff + (n - dense) * moe_outside
    return 2.0 * (macs + d * int(config["vocab_size"])) + routed_flops_per_token(config)


def attention_flops_per_sequence(config: Dict[str, Any], seq_len: int) -> float:
    """The forward's two attention products (Q.K^T over the q/k width, P.V
    over the v width) of one sequence, over every layer and head, on the
    causal pairs."""
    n, _, qk, dv, h = _sizes(config)
    return 2.0 * causal_pairs(seq_len) * (qk + dv) * h * n


def step_flops(config: Dict[str, Any], seq_len: int, rows: int) -> Dict[str, float]:
    """A training step's needed FLOPs on ``rows`` sequences of ``seq_len``:
    ``products`` (forward and the backward's two per product), of which
    ``routed`` are the routed experts'; ``attention_fwd`` (K1's two
    products), ``attention_bwd`` (the backward's four: twice the forward's)
    and ``attention`` their sum; and ``total``."""
    tokens = seq_len * rows
    products = 3.0 * product_flops_per_token(config) * tokens
    fwd = attention_flops_per_sequence(config, seq_len) * rows
    return {"products": products, "routed": 3.0 * routed_flops_per_token(config) * tokens,
            "attention_fwd": fwd, "attention_bwd": 2.0 * fwd, "attention": 3.0 * fwd,
            "total": products + 3.0 * fwd}
