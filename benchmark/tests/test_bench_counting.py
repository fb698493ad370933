"""The yardstick's arithmetic against hand counts: the FLOPs a step needs,
and the reduction of a device trace (interval unions, exposed collective
time, kernel classes, idle gaps by host operation)."""

import importlib.util
import json
import os

import pytest

from benchmark import trace
from benchmark.flops import decoder, resnet

import tiny

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small(layers, d, h, kv, dh, ff, vocab):
    return {"hidden_size": d, "num_attention_heads": h, "num_key_value_heads": kv,
            "intermediate_size": ff, "vocab_size": vocab, "num_hidden_layers": layers,
            "assumed": {"head_dim": dh}}


@pytest.mark.parametrize("shape,seq,rows,products,attention", [
    # 1 layer, d 4, 2 heads of 2, 1 kv head, ff 8, vocab 10, T 3, 1 row:
    # per token 2 * (4*(4+2+2) + 4*4 + 3*4*8 + 4*10) = 2 * 184 = 368, x 3 tokens
    # x 3 = 3312; attention 2 products x 2 x 6 pairs x 2 x 2 heads = 96, x 3 = 288
    ((1, 4, 2, 1, 2, 8, 10), 3, 1, 3312.0, 288.0),
    # 2 layers, d 8, 4 heads of 2, 2 kv heads, ff 16, vocab 5, T 4, 2 rows:
    # per token 2 * (2 * (8*(8+4+4) + 8*8 + 3*8*16) + 8*5) = 2 * 1192 = 2384,
    # x 8 tokens x 3 = 57216; attention 4 x 10 pairs x 2 x 4 heads x 2 layers
    # = 640 per row, x 2 rows x 3 = 3840
    ((2, 8, 4, 2, 2, 16, 5), 4, 2, 57216.0, 3840.0),
])
def test_decoder_step_flops(shape, seq, rows, products, attention):
    got = decoder.step_flops(_small(*shape), seq, rows)
    assert got == {"products": products, "attention": attention,
                   "total": products + attention}


def test_mistral_layer_counts():
    c = _config("mistral-7b-l8")
    # q/k/v 4096 x (4096 + 2 x 1024), o 4096 x 4096, FFN 3 x 4096 x 14336, head
    per_layer = 4096 * 6144 + 4096 * 4096 + 3 * 4096 * 14336
    assert decoder.product_flops_per_token(c) == 2.0 * (8 * per_layer + 4096 * 32768)
    # causal: half of T^2 plus the diagonal, not T^2
    assert decoder.attention_flops_per_sequence(c, 4096) == 4.0 * 4096 * 4097 / 2 * 128 * 32 * 8


def _resnet(blocks, width, size, classes):
    return {"stage_blocks": blocks, "width": width, "image_size": size, "channels": 3,
            "num_classes": classes}


def test_resnet_flops_by_hand():
    # one bottleneck block (4 -> 4 -> 16, projection), 8 px: stem 7x7x3x4 at
    # 4x4, pool to 2x2, 1x1 4->4, 3x3 4->4, 1x1 4->16, proj 4->16 at 2x2,
    # head 16 x 2
    c = _resnet([1], 4, 8, 2)
    macs = 49 * 3 * 4 * 16 + 4 * 4 * 4 + 9 * 4 * 4 * 4 + 4 * 16 * 4 + 4 * 16 * 4 + 16 * 2
    assert resnet.forward_flops_per_sample(c) == 2.0 * macs
    assert resnet.step_flops(c, 5)["total"] == 3 * 2.0 * macs * 5


def test_resnet101_matches_its_published_size():
    # ResNet-101 v1.5 at 224 px: 7.8 G multiply-adds a forward image
    assert 15.4e9 < resnet.forward_flops_per_sample(_config("resnet101-f32")) < 15.8e9


def _trace():
    device = [("nvjet_tst_gemm", 0.0, 10.0), ("flash_fwd_kernel<128>", 5.0, 15.0),
              ("ncclDevKernel_AllGather", 12.0, 30.0), ("elementwise_kernel", 40.0, 45.0),
              ("Memcpy HtoD", 45.0, 50.0)]
    host = [("train_step", 0.0, 60.0), ("aten::mm", 30.0, 38.0),
            ("cudaLaunchKernel", 31.0, 33.0)]
    return trace.Trace(device, host, wall_s=100e-6, steps=2)


def test_union_and_busy():
    assert trace.merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert trace.union_length([(0, 10), (5, 15), (12, 30), (40, 50)]) == 40
    assert _trace().busy_s() == pytest.approx(40e-6)


def test_exposed_collective_time():
    t = _trace()
    exposed = t.exposed_s(lambda n: trace.has_part(n, ("nccl",)),
                          lambda n: not trace.has_part(n, ("nccl",) + trace.COPY_PARTS))
    assert exposed == pytest.approx(15e-6)  # 15..30 runs NCCL alone


def test_classes_and_gaps():
    t = _trace()
    flash = t.time_s(lambda n: trace.has_part(n, ("flash_fwd_kernel",)))
    assert flash == pytest.approx(10e-6)
    gaps = dict(t.idle_gaps())
    # the gap 30..40 is under aten::mm (30..38) at its middle, 35; the launch
    # inside it (31..33) has ended by then
    assert gaps == {"aten::mm": pytest.approx(10e-6)}
    assert t.top_device_ops(2) == [["ncclDevKernel_AllGather", pytest.approx(18e-6)],
                                   ["nvjet_tst_gemm", pytest.approx(10e-6)]]


class _Run:
    def __init__(self, tr, unit="tokens", chips=1):
        self.trace, self.unit, self.chips = tr, unit, chips
        self.root = tiny.ROOT


@pytest.mark.parametrize("gang,one", [("elementwise_ms.fsdp", "elementwise_ms.decoder"),
                                      ("idle_share.fsdp", "idle_share.decoder")])
def test_gang_readers_read_as_their_one_card_metric_on_several_cards(gang, one):
    assert _reader(gang).read(_Run(_trace(), chips=4)) == _reader(one).read(_Run(_trace()))
    assert _reader(gang).read(_Run(_trace(), chips=1)) is None


def test_exposed_collectives_per_step_on_several_cards():
    reader = _reader("comm_exposed_ms.fsdp")
    assert reader.read(_Run(_trace(), chips=4)) == pytest.approx(1e3 * 15e-6 / 2)
    assert reader.read(_Run(_trace(), chips=1)) is None
    no_nccl = trace.Trace([("nvjet_tst_gemm", 0.0, 10.0)], [], 1.0, 1)
    assert reader.read(_Run(no_nccl, chips=4)) is None


def test_elementwise_class_leaves_out_products_kernels_and_copies():
    ms = _reader("elementwise_ms.decoder").read(_Run(_trace()))
    assert ms == pytest.approx(1e3 * 5e-6 / 2)  # the one elementwise kernel, per step


def test_readers_return_nothing_without_their_work():
    assert _reader("elementwise_ms.decoder").read(_Run(None)) is None
    assert _reader("idle_share.resnet").read(_Run(_trace(), "tokens")) is None
    empty = trace.Trace([], [], 1.0, 1)
    assert _reader("idle_share.decoder").read(_Run(empty)) is None
