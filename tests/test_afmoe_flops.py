"""``benchmark/flops/afmoe.py`` against counts by brute force at tiny sizes:
the (query, key) pairs a sliding window lets through, the routed experts'
products on the T·k assignments (padding not counted), and a whole step's
needed FLOPs written out by hand; and the cell's configuration at its
published widths against the figures worked out by hand for it: 1,036
MFLOP of products and 214 of attention a token at T 8192, 122.8 TFLOP a
step of 4 x 8192 tokens."""

import json
import os

import pytest

from benchmark.flops import afmoe as flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TYPES = ["sliding_attention", "sliding_attention", "sliding_attention", "full_attention"]


def _tiny(layers=2, dense=1, types=TYPES):
    return {"hidden_size": 4, "num_attention_heads": 2, "num_key_value_heads": 1,
            "head_dim": 2, "intermediate_size": 6, "moe_intermediate_size": 3,
            "vocab_size": 10, "num_hidden_layers": layers, "num_dense_layers": dense,
            "num_experts": 5, "num_experts_per_tok": 2, "num_shared_experts": 1,
            "sliding_window": 3, "layer_types": types}


@pytest.mark.parametrize("t,w", [(1, 1), (5, 1), (5, 3), (7, 3), (3, 5), (8, 8), (64, 16)])
def test_window_pairs_count_the_visible_pairs(t, w):
    brute = sum(1 for i in range(t) for j in range(t) if 0 <= i - j < w)
    assert flops.window_pairs(t, w) == brute
    assert flops.causal_pairs(t) == sum(1 for i in range(t) for j in range(t) if j <= i)


@pytest.mark.parametrize("layers,dense,k", [(2, 1, 2), (4, 1, 1), (3, 3, 2)])
def test_routed_products_count_the_assignments(layers, dense, k):
    """Each MoE layer routes every token to k experts, each running three
    products of d x fe: 2 MACs each, with no padding or recompute."""
    c = {**_tiny(layers, dense), "num_experts_per_tok": k}
    brute = 0
    for layer in range(layers):
        if layer >= dense:
            for _ in range(k):  # one token's assignments
                brute += 2 * (4 * 3 + 4 * 3 + 3 * 4)
    assert flops.routed_flops_per_token(c) == brute


def test_step_flops_by_hand():
    # 2 layers: layer 0 dense (sliding), layer 1 MoE (sliding); d 4, 2 heads
    # of 2, 1 kv head, ff 6, fe 3, 5 experts top-2, 1 shared, vocab 10, W 3.
    # per token: attention projections 2 * (4*(4+4+2+2) + 4*4) = 128 a layer;
    # dense 2 * 3*4*6 = 144; router 2 * 4*5 = 40; shared 2 * 3*4*3 = 72;
    # routed 2 * 2 * 3*4*3 = 144; head 2 * 4*10 = 80
    c = _tiny()
    per_token = 2 * 128 + 144 + 40 + 72 + 144 + 80
    assert flops.product_flops_per_token(c) == per_token
    # T 5: sliding layers read 3*4/2 + 2*3 = 12 pairs each; 2 products * 2 * dh * heads
    assert flops.attention_flops_per_sequence(c, 5) == 2 * 12 * 2 * 2 * 2 * 2
    out = flops.step_flops(c, 5, 3)
    assert out["products"] == 3 * per_token * 15
    assert out["routed"] == 3 * 144 * 15
    assert out["attention"] == 3 * 3 * 2 * 12 * 16
    assert out["total"] == out["products"] + out["attention"]


def test_the_cells_configuration_at_its_published_widths():
    with open(os.path.join(ROOT, "benchmark", "configs", "trinity-mini-l6.json")) as f:
        c = json.load(f)
    assert [t[0] for t in c["layer_types"][:6]] == list("sssfss")
    assert flops.window_pairs(8192, 2048) == 14_681_088
    assert round(flops.product_flops_per_token(c) / 1e6) == 1036
    assert round(flops.attention_flops_per_sequence(c, 8192) / 8192 / 1e6) == 214
    assert round(flops.step_flops(c, 8192, 4)["total"] / 1e12, 1) == 122.8
