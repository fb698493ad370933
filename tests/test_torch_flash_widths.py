"""Flash attention with v narrower than q and k (multi-head latent
attention's widths), on the CPU: the plain forward and backward against a
dense reference at q/k 24 and v 16, the operators' shapes, and the CUDA
wrappers' refusal of every unequal pair but the compiled (192, 128), by
name and before any launch.

Tolerances: f32 on both sides, which sum in other orders (2e-5 forward,
5e-4 gradients, as the JAX suite's f32 bounds).
"""

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.kernels import flash_attention as tfa

F32_FWD, F32_GRAD = 2e-5, 5e-4


def _qkv(seed, t, h, h_kv, d, dv, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    shapes = ((1, h, t, d), (1, h_kv, t, d), (1, h_kv, t, dv), (1, h, t, dv))
    return tuple(torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype) for s in shapes)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,h,h_kv,block", [(40, 4, 4, 16), (72, 4, 2, 32), (200, 2, 2, 128)])
def test_plain_forward_and_backward_match_dense_at_unequal_widths(causal, t, h, h_kv, block):
    """K1's and the backward's plain versions at q/k 24, v 16 (ragged T,
    MHA and GQA) against the dense reference's forward and autograd."""
    q, k, v, do = _qkv(t + h, t, h, h_kv, 24, 16)
    scale = 24 ** -0.5
    o, lse = tfa.flash_fwd_plain(q, k, v, causal, scale, block_q=block, block_k=block)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    ref = tfa._dense_reference(qr, kr, vr, causal=causal, scale=scale)
    assert o.shape == (1, h, t, 16) and lse.shape == (1, h, t)
    torch.testing.assert_close(o, ref.detach(), atol=F32_FWD, rtol=F32_FWD)
    ref.backward(do)
    delta = (do * o).sum(-1)
    dq, dk, dv = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    for got, want in ((dq, qr.grad), (dk, kr.grad), (dv, vr.grad)):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, atol=F32_GRAD, rtol=F32_GRAD)


def test_flash_attention_autograd_at_unequal_widths():
    """The differentiable operator in model layout (q [B,T,H,24], v
    [B,T,H,16]) gives o of v's width, the default scale 24^-1/2 and the
    dense reference's gradients; its fake gives the same shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    q, k, v, do = (x.transpose(1, 2) for x in _qkv(3, 56, 4, 4, 24, 16))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(qg, kg, vg, block_q=16, block_k=16)
    assert o.shape == (1, 56, 4, 16)
    o.backward(do)
    qr, kr, vr = (x.transpose(1, 2).clone().requires_grad_() for x in (q, k, v))
    ref = tfa._dense_reference(qr, kr, vr, causal=True, scale=24 ** -0.5)
    torch.testing.assert_close(o.detach(), ref.detach().transpose(1, 2), atol=F32_FWD,
                               rtol=F32_FWD)
    ref.backward(do.transpose(1, 2))
    for got, want in ((qg, qr), (kg, kr), (vg, vr)):
        torch.testing.assert_close(got.grad, want.grad.transpose(1, 2), atol=F32_GRAD,
                                   rtol=F32_GRAD)
    heads_major = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(x) for x in heads_major)
        fo, flse = tfa.flash_fwd_op(fq, fk, fv, True, 0.2, 128, 128)
    assert fo.shape == (1, 4, 56, 16) and flse.shape == (1, 4, 56)


@pytest.mark.parametrize("d,dv", [(192, 64), (128, 192), (128, 64), (64, 32), (256, 128)])
def test_the_cuda_wrappers_refuse_other_unequal_pairs_by_name(d, dv):
    """Only (192, 128) is compiled beside the equal widths: any other pair
    is refused, naming the pair, before a tensor's device is looked at."""
    q, k, v, do = _qkv(0, 8, 2, 2, d, dv, torch.bfloat16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match=rf"\({d}, {dv}\)"):
        tfa.flash_fwd_cuda(q, k, v, True, 1.0)
    with pytest.raises(ValueError, match=rf"\({d}, {dv}\)"):
        tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, lse, torch.zeros(q.shape), True, 1.0)


def test_the_compiled_pair_passes_the_checks_and_takes_no_window():
    """(192, 128) passes ``_dims`` (and then needs a CUDA tensor); with a
    window, or v of another length than k, it is refused."""
    q, k, v, _ = _qkv(0, 8, 2, 2, 192, 128, torch.bfloat16)
    assert (192, 128) in tfa.UNEQUAL_HEAD_DIMS
    assert tfa._dims(q, k, v) == (1, 2, 2, 8, 192, 128)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tfa.flash_fwd_cuda(q, k, v, True, 1.0)
    with pytest.raises(ValueError, match="no window"):
        tfa.flash_fwd_cuda(q, k, v, True, 1.0, 4)
    with pytest.raises(ValueError, match="before the head width"):
        tfa.flash_fwd_cuda(q, k, v[:, :, :4], True, 1.0)
    with pytest.raises(ValueError, match="the dq pass"):
        tfa.flash_bwd_dq_cuda(torch.zeros(1, 2, 8, 96), 1.0)
