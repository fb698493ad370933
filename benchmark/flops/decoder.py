"""FLOPs a decoder training step needs, from the configuration's shapes.

Needed work only: the forward pass, and the backward's two products for
each forward product (3x the forward in all). Causal attention needs the
T(T+1)/2 query-key pairs at or below the diagonal, not T^2. The remat's
recompute, and whatever a kernel computes beyond the causal pairs, is not
needed and is not counted.
"""

from __future__ import annotations

from typing import Any, Dict


def _dims(config: Dict[str, Any]):
    d = int(config["hidden_size"])
    h = int(config["num_attention_heads"])
    kv = int(config["num_key_value_heads"])
    dh = int(config["assumed"]["head_dim"])
    return d, h, kv, dh, int(config["intermediate_size"]), int(config["vocab_size"])


def product_flops_per_token(config: Dict[str, Any]) -> float:
    """The forward's matrix products per token, 2 x MACs: the q/k/v, output
    and three FFN projections of every layer, and the LM head."""
    d, h, kv, dh, ff, vocab = _dims(config)
    per_layer = d * (h * dh + 2 * kv * dh) + h * dh * d + 3 * d * ff
    return 2.0 * (int(config["num_hidden_layers"]) * per_layer + d * vocab)


def attention_flops_per_sequence(config: Dict[str, Any], seq_len: int) -> float:
    """The forward's two attention products (Q.K^T and P.V) of one sequence,
    over every layer and query head, on the causal pairs only."""
    _, h, _, dh, _, _ = _dims(config)
    pairs = seq_len * (seq_len + 1) / 2
    return 2.0 * 2.0 * pairs * dh * h * int(config["num_hidden_layers"])


def step_flops(config: Dict[str, Any], seq_len: int, rows: int) -> Dict[str, float]:
    """A training step's needed FLOPs on ``rows`` sequences of ``seq_len``:
    ``products`` (forward and the backward's two per product), ``attention``
    (forward's two products and the backward's four), and ``total``."""
    products = 3.0 * product_flops_per_token(config) * seq_len * rows
    attention = 3.0 * attention_flops_per_sequence(config, seq_len) * rows
    return {"products": products, "attention": attention, "total": products + attention}
