"""The port's workloads on a CUDA card: the quantized products, ResNet, the
entry point, and the twins of two ``tests_tpu/`` files.

- ``kernels/quant_matmul``'s card products (``torch._int_mm``,
  ``torch._scaled_mm``) against their plain versions: int8 bit for bit
  (int32 sums are exact), fp8 within one bf16 ulp of each value plus 1e-3
  of max (the tensor cores' f32 sums round in another order); the straight-through backward;
- a small ResNet (resnet26, image 64) on the card against the CPU from the
  same weights: loss within 1e-2 relative, grad norm within 5e-2, as
  chip_smoke.py holds the Llama;
- ``entry.entry()``: the head_dim-32 Llama's forward through K1;
- ``tests_tpu/test_flash_on_tpu.py``'s ``test_long_context_16k_trains``:
  forward and backward at T 16384 are finite;
- ``tests_tpu/test_moe_on_tpu.py``'s two tests: the MoE layer on the card
  against its op-by-op run on the CPU, and a finite backward that reaches
  the router.

Skips without a card. Imports no JAX, so on the card's machine:

    python -m pytest --noconftest tests/test_torch_workloads_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card's library products and kernels have no "
                    "CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["int8", "fp8"])
@pytest.mark.parametrize("m, k, n", [(8192, 2048, 7168), (8192, 7168, 2048), (5, 64, 48),
                                     (40, 128, 32)])
def test_quant_products_match_plain(precision, m, k, n):
    from mpi_operator_tpu_torch.kernels import quant_matmul as qm

    _need_card()
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).cuda().to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32)).cuda().to(torch.bfloat16)
    qm.reset_launches()
    got = qm.forward_2d(x, w, precision)
    torch.cuda.synchronize()
    assert qm.launches[precision] == 1
    want = qm.forward_2d(x.cpu(), w.cpu(), precision)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    if precision == "int8":
        assert torch.equal(got.cpu(), want)
    else:  # one bf16 ulp of each value (2^-7 of it at most), 1e-3 of max near zero
        slack = (got.cpu().float() - want.float()).abs() - 2 ** -7 * want.float().abs()
        assert float(slack.max()) <= 1e-3 * float(want.float().abs().max())
    assert qm.quant_error(x, w, precision=precision) < (0.02 if precision == "int8" else 0.06)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["int8", "fp8"])
def test_quant_backward_is_the_full_precision_product(precision):
    from mpi_operator_tpu_torch.kernels.quant_matmul import quant_matmul

    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(64, 128, generator=gen, device="cuda", requires_grad=True)
    w = torch.randn(128, 96, generator=gen, device="cuda", requires_grad=True)
    c = torch.randn(64, 96, generator=gen, device="cuda")
    gx, gw = torch.autograd.grad((quant_matmul(x, w, precision=precision) * c).sum(), (x, w))
    ex, ew = torch.autograd.grad(((x @ w) * c).sum(), (x, w))
    torch.testing.assert_close(gx, ex)
    torch.testing.assert_close(gw, ew)


@pytest.mark.cuda
def test_resnet_on_the_card_matches_the_cpu():
    from mpi_operator_tpu_torch.models import resnet
    from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_imagenet
    from mpi_operator_tpu_torch.ops.trainer import global_norm

    _need_card()
    cfg = resnet.Config(depth="resnet26", image_size=64, num_classes=10)
    host = next(synthetic_imagenet(global_batch=8, image_size=64, num_classes=10,
                                   process_index=0, process_count=1))
    base = resnet.init(cfg, torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        model = resnet.ResNet(cfg, device=dev)
        model.load_state_dict(base.state_dict())
        loss = resnet.loss_fn(model, make_global_batch(host, dev))
        loss.backward()
        out[dev] = (loss.item(), global_norm([p.grad for p in model.parameters()]).item())
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert math.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu), out
    assert abs(g_gpu - g_cpu) <= 5e-2 * g_cpu, out


@pytest.mark.cuda
def test_entry_runs_the_head_dim_32_forward_on_the_card():
    from mpi_operator_tpu_torch import entry
    from mpi_operator_tpu_torch.kernels import flash_attention as tfa

    _need_card()
    fn, args = entry.entry()
    tfa.reset_launches()
    with torch.no_grad():
        logits = fn(*args)
    torch.cuda.synchronize()
    assert logits.shape == (2, 128, 2048) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    assert tfa.launches["flash_fwd"] == entry.config().n_layers


@pytest.mark.cuda
def test_long_context_16k_trains():
    from mpi_operator_tpu_torch.kernels.flash_attention import flash_attention

    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = rnd(1, 16384, 8, 128), rnd(1, 16384, 4, 128), rnd(1, 16384, 4, 128)
    for t in (q, k, v):
        t.requires_grad_()
    grads = torch.autograd.grad(flash_attention(q, k, v, causal=True).float().sum(), (q, k, v))
    for g in grads:
        assert bool(torch.isfinite(g.float()).all())


def _moe_setup(seed, b=4, t=256, d=128, d_ff=512, e=8):
    from mpi_operator_tpu_torch.parallel import moe

    cfg = moe.MoEConfig(d_model=d, d_ff=d_ff, n_experts=e)
    params = moe.init(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    x = torch.randn(b, t, d, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                    device="cuda")
    return cfg, params, x


@pytest.mark.cuda
def test_compiled_forward_matches_op_by_op():
    """The card's forward against the same layer run on the CPU."""
    from mpi_operator_tpu_torch.parallel import moe

    _need_card()
    cfg, params, x = _moe_setup(0)
    with torch.no_grad():
        y, aux = moe.apply(cfg, params, x)
        y_ref, aux_ref = moe.apply(cfg, {g: {"w": p["w"].cpu()} for g, p in params.items()},
                                   x.cpu())
    torch.testing.assert_close(y.cpu(), y_ref, atol=5e-2, rtol=5e-2)
    assert abs(float(aux) - float(aux_ref)) <= 1e-3 * float(aux_ref)
    assert 0.9 < float(aux) < 3.0


@pytest.mark.cuda
def test_compiled_backward_runs_and_is_finite():
    from mpi_operator_tpu_torch.parallel import moe

    _need_card()
    cfg, params, x = _moe_setup(2)
    leaves = [params[g]["w"].requires_grad_() for g in params]
    y, aux = moe.apply(cfg, params, x)
    grads = torch.autograd.grad((y * y).mean() + 0.01 * aux, leaves)
    assert grads and all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[list(params).index("router")].abs().max()) > 0.0
