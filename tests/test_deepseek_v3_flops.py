"""``benchmark/flops/deepseek_v3.py`` against counts written out by hand at a
tiny size (the products of every projection, the experts on the T·k
assignments, attention on the causal pairs at the q/k and v widths), and
the cell's configuration at its published widths: 3,329,913,856 parameters
(a dense layer 64.10 M, an MoE layer 640.03 M) and the attention FLOPs of a
step of 32,768 tokens worked out by hand."""

import json
import os

import pytest

from benchmark.flops import deepseek_v3 as flops
from benchmark.reference import deepseek_v3 as ref
from mpi_operator_tpu_torch.models import deepseek_v3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(layers=2, dense=1):
    return {"hidden_size": 4, "num_attention_heads": 2, "qk_nope_head_dim": 2,
            "qk_rope_head_dim": 2, "v_head_dim": 3, "kv_lora_rank": 5, "intermediate_size": 6,
            "moe_intermediate_size": 3, "vocab_size": 10, "num_hidden_layers": layers,
            "first_k_dense_replace": dense, "n_routed_experts": 5, "num_experts_per_tok": 2,
            "n_shared_experts": 2}


@pytest.mark.parametrize("t", [1, 2, 5, 64])
def test_causal_pairs_count_the_visible_pairs(t):
    assert flops.causal_pairs(t) == sum(1 for i in range(t) for j in range(t) if j <= i)


def test_step_flops_by_hand():
    # 2 layers: layer 0 dense, layer 1 MoE; d 4, 2 heads of q/k 2 + 2 and v 3,
    # latent 5, ff 6, fe 3, 5 experts top-2, 2 shared, vocab 10. Per token:
    # attention 2 * (4*2*4 + 4*(5+2) + 5*2*(2+3) + 2*3*4) = 2 * 134 = 268 a layer;
    # dense 2 * 3*4*6 = 144; router 2 * 4*5 = 40; shared 2 * 2*3*4*3 = 144;
    # routed 2 * 2 * 3*4*3 = 144; head 2 * 4*10 = 80
    c = _tiny()
    per_token = 2 * 268 + 144 + 40 + 144 + 144 + 80
    assert flops.product_flops_per_token(c) == per_token
    assert flops.routed_flops_per_token(c) == 144
    # T 5: 15 causal pairs a head; q.k over 4 and p.v over 3: 2 * 15 * 7 * 2 heads * 2 layers
    assert flops.attention_flops_per_sequence(c, 5) == 2 * 15 * 7 * 2 * 2
    out = flops.step_flops(c, 5, 3)
    assert out["products"] == 3 * per_token * 15
    assert out["routed"] == 3 * 144 * 15
    fwd = 3 * 2 * 15 * 7 * 2 * 2
    assert (out["attention_fwd"], out["attention_bwd"], out["attention"]) == (fwd, 2 * fwd, 3 * fwd)
    assert out["total"] == out["products"] + out["attention"]


def test_the_cell_at_its_published_widths():
    with open(os.path.join(ROOT, "benchmark", "configs", "kanana-2-30b-a3b-l6.json")) as f:
        c = json.load(f)
    s = ref.Shape(c)
    port = deepseek_v3.Config(
        vocab=s.vocab, d_model=s.d, n_layers=s.layers, n_heads=s.h, qk_nope_dim=s.nope,
        qk_rope_dim=s.rope, v_dim=s.dv, kv_rank=s.rank, d_ff=s.ff, n_dense_layers=s.dense,
        n_experts=s.experts, top_k=s.top_k, d_expert=s.fe, n_shared_experts=s.shared)
    assert deepseek_v3.param_count(port) == c["parameters"] == 3_329_913_856
    attn = 2048 * 32 * 192 + 2048 * 576 + 512 * 32 * 256 + 32 * 128 * 2048 + 2 * 2048 + 512
    assert attn + 3 * 2048 * 6144 == 64_098_816  # the dense layer
    assert attn + 2048 * 128 + 130 * 3 * 2048 * 768 == 640_029_184  # an MoE layer
    # attention at T 32768: 536,887,296 causal pairs a head, 32 heads, 6 layers;
    # the forward's q.k over 192 and p.v over 128, the backward twice that
    out = flops.step_flops(c, 32768, 1)
    pairs = 32768 * 32769 // 2
    assert pairs == 536_887_296
    assert out["attention_fwd"] == 2 * pairs * (192 + 128) * 32 * 6
    assert out["attention_fwd"] == pytest.approx(6.5971e13, rel=1e-4)
    assert out["attention_bwd"] == 2 * out["attention_fwd"]
