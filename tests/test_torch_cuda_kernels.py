"""The hand-written CUDA kernels against their plain versions, on the card.

Skips without a CUDA card (the kernels have no CPU or interpret mode).
Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Bounds as in chip_smoke.py: o 3e-2 abs, lse 1e-3 abs, dq/dk/dv
3e-2·max|ref| as ceilings, and beside them every row within TOL_ROW of the
reference row, relative to its RMS.
"""

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.kernels import flash_attention as tfa

TOL_ROW = 1e-2


def _inputs(seed, b, t, h, h_kv, d):
    rng = np.random.default_rng(seed)
    shapes = ((b, h, t, d), (b, h_kv, t, d), (b, h_kv, t, d), (b, h, t, d))
    return tuple(
        torch.from_numpy(rng.standard_normal(s, np.float32)).to(torch.bfloat16).cuda()
        for s in shapes
    )


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _row_err(got, ref):
    """Worst per-row relative RMS error, rows floored at 0.1 x the tensor's
    RMS (chip_smoke.py's tight check)."""
    g = got.float().reshape(-1, got.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    row_rms = r.pow(2).mean(-1).sqrt().clamp_min(0.1 * float(r.pow(2).mean().sqrt()))
    return float(((g - r).pow(2).mean(-1).sqrt() / row_rms).max())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")


def _check_against_plain(seed, b, t, h, h_kv, d, causal):
    """K1, K2 and K3 against their plain versions on one input."""
    q, k, v, do = _inputs(seed, b, t, h, h_kv, d)
    scale = d ** -0.5
    o, lse = tfa.flash_fwd_cuda(q, k, v, causal, scale)
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, causal, scale)
    assert _max_err(o, o_ref) <= 3e-2
    assert _row_err(o, o_ref) <= TOL_ROW
    assert _max_err(lse, lse_ref) <= 1e-3
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, causal, scale)
    got = (tfa.flash_bwd_dq_cuda(*args), *tfa.flash_bwd_dkv_cuda(*args))
    want = (tfa.flash_bwd_dq_plain(*args), *tfa.flash_bwd_dkv_plain(*args))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert _max_err(g, w) <= 3e-2 * float(w.float().abs().max())
        assert _row_err(g, w) <= TOL_ROW


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_kernels_match_plain(causal, d):
    """K1, K2 and K3 with ragged T (200) and GQA (8 q heads on 2 kv heads)."""
    _need_card()
    _check_against_plain(5, 2, 200, 8, 2, d, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize(
    "t,h,h_kv",
    [
        (17, 8, 2),    # T shorter than one tile
        (65, 8, 2),    # T one past K2's first k stage, inside one q tile
        (129, 8, 2),   # T one past a tile boundary
        (129, 4, 4),   # MHA, g = 1
        (200, 8, 1),   # g = 8
    ],
)
def test_cuda_kernels_edge_shapes(t, h, h_kv, d, causal):
    """K1's 128 x 128, K2's 128 q x 64 k and K3's 128 k x 64 q tiles at the
    edges of T and of the q-head group; at D 16 and 32 also the columns the
    TMA box zero-fills past D, which must change no sum and never be stored."""
    _need_card()
    _check_against_plain(6, 1, t, h, h_kv, d, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_operand_layouts(n, d):
    """The wgmma paths K1–K3 are built from, against plain products: S =
    A·Bᵀ with both operands K-major in 128B-swizzled TMA tiles (two column
    blocks at D128), then O = bf16(S)·V with S's f32 accumulator used in
    place as the register A operand and V read MN-major. A wrong descriptor
    or fragment mapping moves whole rows or columns, far past these bounds."""
    _need_card()
    rng = np.random.default_rng(n * 1000 + d)
    a, b, v = (
        torch.from_numpy(rng.standard_normal(s, np.float32)).to(torch.bfloat16).cuda()
        for s in ((64, d), (n, d), (n, d))
    )
    s, o = tfa.wgmma_probe_cuda(a, b, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, a.float() @ b.float().T, atol=1e-3, rtol=1e-4)
    o_ref = s.to(torch.bfloat16).float() @ v.float()
    torch.testing.assert_close(o, o_ref, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_kernels_bitwise_deterministic(d):
    """No atomics: two launches of K1, K2 or K3 on the same inputs give the
    same bits."""
    _need_card()
    q, k, v, do = _inputs(8, 2, 300, 8, 2, d)
    scale = d ** -0.5
    o1, lse1 = tfa.flash_fwd_cuda(q, k, v, True, scale)
    o2, lse2 = tfa.flash_fwd_cuda(q, k, v, True, scale)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    delta = (do.float() * o1.float()).sum(-1)
    args = (q, k, v, do, lse1, delta, True, scale)
    assert torch.equal(tfa.flash_bwd_dq_cuda(*args), tfa.flash_bwd_dq_cuda(*args))
    dk1, dv1 = tfa.flash_bwd_dkv_cuda(*args)
    dk2, dv2 = tfa.flash_bwd_dkv_cuda(*args)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.cuda
def test_cuda_wrapper_checks_run_before_any_launch():
    """Unsupported inputs raise before the kernel is launched or counted."""
    _need_card()
    tfa.reset_launches()
    x = torch.zeros(1, 2, 8, 64, device="cuda")
    with pytest.raises(ValueError, match="bf16"):
        tfa.flash_fwd_cuda(x, x, x, True, 1.0)
    with pytest.raises(ValueError, match="tiles"):
        tfa.flash_attention(*(x.bfloat16(),) * 3, block_q=32, block_k=32, layout="bhtd")
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd_cuda(*(torch.zeros(1, 2, 8, 48, dtype=torch.bfloat16, device="cuda"),) * 3,
                           True, 1.0)
    assert tfa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


@pytest.mark.cuda
def test_operators_launch_the_kernels_bitwise():
    """The torch.library operators reach the same launchers: on CUDA tensors
    flash_fwd_op, flash_bwd_dq_op and flash_bwd_dkv_op give bitwise the
    launchers' outputs, and each counts one launch."""
    _need_card()
    q, k, v, do = _inputs(9, 2, 257, 8, 2, 128)
    scale = 128 ** -0.5
    o, lse = tfa.flash_fwd_cuda(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale)
    want = (o, lse, tfa.flash_bwd_dq_cuda(*args), *tfa.flash_bwd_dkv_cuda(*args))
    tfa.reset_launches()
    got = (*tfa.flash_fwd_op(q, k, v, True, scale, tfa.BLOCK_Q, tfa.BLOCK_K),
           tfa.flash_bwd_dq_op(*args), *tfa.flash_bwd_dkv_op(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tfa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.cuda
def test_remat_launches_k1_once_per_layer_on_the_card():
    """The per-layer remat keeps K1's (o, lse): one forward + backward of a
    small Llama launches K1 once per layer (twice under a plain checkpoint
    of the whole layer), K2 and K3 once each, and the gradients are bitwise
    those without remat."""
    import dataclasses

    from mpi_operator_tpu_torch.models import llama

    _need_card()
    cfg = dataclasses.replace(llama.tiny(), d_model=256, n_heads=4, n_kv_heads=2,
                              head_dim=64, d_ff=512, n_layers=3)
    base = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = {"tokens": torch.randint(0, cfg.vocab, (2, 200), device="cuda")}
    grads = []
    for remat in (False, True):
        model = llama.Llama(dataclasses.replace(cfg, remat_layers=remat), device="cuda")
        model.load_state_dict(base.state_dict())
        tfa.reset_launches()
        llama.loss_fn(model, tokens).backward()
        torch.cuda.synchronize()
        assert tfa.launches == {"flash_fwd": 3, "flash_bwd_dq": 3, "flash_bwd_dkv": 3}
        grads.append([p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
