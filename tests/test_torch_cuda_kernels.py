"""The hand-written CUDA kernels against their plain versions, on the card.

Skips without a CUDA card (the kernels have no CPU or interpret mode).
Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Bounds as in chip_smoke.py: o 3e-2 abs, lse 1e-3 abs, dq/dk/dv
3e-2·max|ref| as ceilings, and beside them every row within TOL_ROW of the
reference row, relative to its RMS. The backward's dq is summed over k
tiles by TMA reduce-adds whose order can change between launches; two
launches are held to each other by ``_reduction_order_close``.
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


def _reduction_order_close(a, b):
    """dq of two launches on the same inputs: the f32 sums differ only in
    the order of their terms, so after the rounding to bf16 each value is
    within one bf16 ulp (2^-7 of it) of the other, plus the f32 reordering
    error of a sum that cancels to near zero (under 1e-5 of max|dq|)."""
    atol = 1e-5 * float(b.float().abs().max())
    torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7, atol=atol)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")


def _check_against_plain(seed, b, t, h, h_kv, d, causal):
    """K1 and the backward (K3 and the dq pass) against their plain
    versions on one input."""
    q, k, v, do = _inputs(seed, b, t, h, h_kv, d)
    scale = d ** -0.5
    o, lse = tfa.flash_fwd_cuda(q, k, v, causal, scale)
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, causal, scale)
    assert _max_err(o, o_ref) <= 3e-2
    assert _row_err(o, o_ref) <= TOL_ROW
    assert _max_err(lse, lse_ref) <= 1e-3
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, causal, scale)
    got = tfa.flash_bwd_cuda(*args)
    want = tfa.flash_bwd_plain(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert _max_err(g, w) <= 3e-2 * float(w.float().abs().max())
        assert _row_err(g, w) <= TOL_ROW


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_kernels_match_plain(causal, d):
    """K1 and the backward with ragged T (200) and GQA (8 q heads on 2 kv
    heads)."""
    _need_card()
    _check_against_plain(5, 2, 200, 8, 2, d, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize(
    "t,h,h_kv",
    [
        (17, 8, 2),    # T shorter than one tile
        (65, 8, 2),    # T one past K3's first q stage, inside one k tile
        (129, 8, 2),   # T one past a tile boundary
        (129, 4, 4),   # MHA, g = 1
        (200, 8, 1),   # g = 8
    ],
)
def test_cuda_kernels_edge_shapes(t, h, h_kv, d, causal):
    """K1's 128 x 128 and K3's 128 k x 64 q tiles at the edges of T and of
    the q-head group; at D 16 and 32 also the columns the TMA box zero-fills
    past D, which must change no sum and never be stored, nor be added into
    dq's accumulator past D."""
    _need_card()
    _check_against_plain(6, 1, t, h, h_kv, d, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1000, 4096])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_fused_backward_matches_plain(t, g, causal, d):
    """The one backward (K3 with dq's reduce-adds, then the dq pass) against
    the plain backward at ragged T 1000 (8 k tiles, a partial last one) and
    T 4096 (32 k tiles, up to 64 reduce-adds into one dq row of a causal
    head), MHA and GQA 4:1, under _check_against_plain's ceilings and
    per-row bars."""
    _need_card()
    _check_against_plain(10 + d + g, 1, t, 2 * g, 2, d, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_kernels_bitwise_deterministic(d):
    """No atomics in K1's o and lse or K3's dk and dv: two launches on the
    same inputs give the same bits. dq's sum is added up by reduce-adds in
    no fixed order: test_dq_of_two_launches_agree_within_reduction_order."""
    _need_card()
    q, k, v, do = _inputs(8, 2, 300, 8, 2, d)
    scale = d ** -0.5
    o1, lse1 = tfa.flash_fwd_cuda(q, k, v, True, scale)
    o2, lse2 = tfa.flash_fwd_cuda(q, k, v, True, scale)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    delta = (do.float() * o1.float()).sum(-1)
    args = (q, k, v, do, lse1, delta, True, scale)
    _, dk1, dv1 = tfa.flash_bwd_cuda(*args)
    _, dk2, dv2 = tfa.flash_bwd_cuda(*args)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_dq_of_two_launches_agree_within_reduction_order(d, causal):
    """Two launches of the backward on the same inputs at T 1000 (8 k tiles
    add into most dq rows) give dq within _reduction_order_close of each
    other, and each within its bars of the plain dq."""
    _need_card()
    q, k, v, do = _inputs(12, 2, 1000, 8, 2, d)
    scale = d ** -0.5
    o, lse = tfa.flash_fwd_cuda(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, scale)
    dq1, dq2 = tfa.flash_bwd_cuda(*args)[0], tfa.flash_bwd_cuda(*args)[0]
    _reduction_order_close(dq1, dq2)
    want = tfa.flash_bwd_plain(*args)[0]
    for dq in (dq1, dq2):
        assert _max_err(dq, want) <= 3e-2 * float(want.float().abs().max())
        assert _row_err(dq, want) <= TOL_ROW


@pytest.mark.cuda
def test_dq_pass_scales_and_rounds():
    """The dq pass is bf16(scale * acc), bit for bit, at a size that is not
    a multiple of its block and takes more than one grid-stride step."""
    _need_card()
    rng = np.random.default_rng(13)
    acc = torch.from_numpy(rng.standard_normal((3, 5, 2 ** 17 + 8, 16), np.float32)).cuda()
    tfa.reset_launches()
    got = tfa.flash_bwd_dq_cuda(acc, 0.125)
    assert tfa.launches["flash_bwd_dq"] == 1
    assert got.dtype == torch.bfloat16 and torch.equal(got, (acc * 0.125).to(torch.bfloat16))
    with pytest.raises(ValueError, match="dq pass"):
        tfa.flash_bwd_dq_cuda(acc.double(), 0.125)


@pytest.mark.cuda
def test_k3_alone_adds_into_the_accumulator():
    """K3 launched alone adds dq's unscaled f32 sum onto what the
    accumulator holds (the smoke times it so, on a buffer it reuses), gives
    the backward's dk and dv bit for bit, and refuses an accumulator it
    could not add into in place before any launch."""
    _need_card()
    q, k, v, do = _inputs(14, 2, 300, 8, 2, 128)
    scale = 128 ** -0.5
    o, lse = tfa.flash_fwd_cuda(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    dq, dk, dv = tfa.flash_bwd_cuda(*args, True, scale)
    base = torch.full(q.shape, 3.0, device="cuda")
    acc = base.clone()
    tfa.reset_launches()
    dk1, dv1 = tfa.flash_bwd_dkv_cuda(*args, acc, True, scale)
    assert tfa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 1}
    assert torch.equal(dk1, dk) and torch.equal(dv1, dv)
    _reduction_order_close(tfa.flash_bwd_dq_cuda(acc - base, scale), dq)
    for bad in (acc.bfloat16(), acc[:, :4], acc.transpose(2, 3).contiguous().transpose(2, 3)):
        with pytest.raises(ValueError, match="dq_acc"):
            tfa.flash_bwd_dkv_cuda(*args, bad, True, scale)
    assert tfa.launches["flash_bwd_dkv"] == 1


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
    flash_fwd_op and flash_bwd_op give the launchers' outputs (bitwise but
    for dq, whose reduce-adds run in no fixed order), and each kernel counts
    one launch."""
    _need_card()
    q, k, v, do = _inputs(9, 2, 257, 8, 2, 128)
    scale = 128 ** -0.5
    o, lse = tfa.flash_fwd_cuda(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale)
    want = (o, lse, *tfa.flash_bwd_cuda(*args))
    tfa.reset_launches()
    got = (*tfa.flash_fwd_op(q, k, v, True, scale, tfa.BLOCK_Q, tfa.BLOCK_K),
           *tfa.flash_bwd_op(*args))
    torch.cuda.synchronize()
    _reduction_order_close(got[2], want[2])
    assert all(torch.equal(g, w) for i, (g, w) in enumerate(zip(got, want)) if i != 2)
    assert tfa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.cuda
def test_remat_launches_k1_once_per_layer_on_the_card():
    """The per-layer remat keeps K1's (o, lse): one forward + backward of a
    small Llama launches K1 once per layer (twice under a plain checkpoint
    of the whole layer), K3 and the dq pass once each, and the gradients are
    bitwise those without remat. At T 200 two k tiles add into a dq row, and
    two f32 adds onto zero give the same bits in either order."""
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


# ---------------------------------------------------------------------------
# the optimizer phase: K-norm and K-adamw (csrc/optim.cu) against their plain
# versions (kernels/optim.py) on the same card
# ---------------------------------------------------------------------------

OPT_SIZES = (1, 7, 4099, 2 ** 20 + 3)
OPT_LR = 1e-2  # large, so that the update moves p by as much as p's own size


def _ulp(x, dtype):
    """One ulp of ``dtype`` at |x|, elementwise (f32 values)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       e - (24 if dtype == torch.float32 else 8))


def _assert_ulps(got, want, scale, n, what):
    """|got - want| within n ulps of got's dtype at ``scale`` (the largest
    operand of the last rounding: a difference that a sum cancels is still
    a difference at the operands' size)."""
    err = (got.float() - want.float()).abs()
    tol = n * _ulp(torch.maximum(scale.float().abs(), want.float().abs()), got.dtype)
    worst = float((err / tol).max())
    assert worst <= 1.0, f"{what}: {worst * n:.2f} ulps"


def _opt_state(mu_bf16, seed=0):
    """name -> p for every OPT_SIZES leaf and a leaf whose p, g, mu and nu
    are views one element past a 16-byte boundary; zero moments."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mu_dtype = torch.bfloat16 if mu_bf16 else torch.float32
    params, mu, nu = {}, {}, {}
    for n in OPT_SIZES:
        name = f"leaf{n}"
        params[name] = torch.randn(n, generator=gen, device="cuda") * 0.02
        mu[name] = torch.zeros(n, dtype=mu_dtype, device="cuda")
        nu[name] = torch.zeros(n, device="cuda")
    params["view"] = (torch.randn(4100, generator=gen, device="cuda") * 0.02)[1:]
    mu["view"] = torch.zeros(4100, dtype=mu_dtype, device="cuda")[1:]
    nu["view"] = torch.zeros(4100, device="cuda")[1:]
    return params, {"mu": mu, "nu": nu}


def _opt_grads(params, step, target):
    """Gradients for ``step`` whose global norm is about ``target``."""
    gen = torch.Generator(device="cuda").manual_seed(100 + step)
    total = sum(p.numel() for p in params.values())
    grads = {}
    for name, p in params.items():
        g = torch.randn(p.numel() + 1, generator=gen, device="cuda") * (target / total ** 0.5)
        grads[name] = g[1:] if name == "view" else g[:-1]
    return grads


@pytest.mark.cuda
@pytest.mark.parametrize("target", [0.5, 4.0], ids=["below", "above"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("mu_bf16", [True, False])
def test_optimizer_kernels_match_plain(mu_bf16, wd, target):
    """Three steps of the clip (max_norm 1, the norm below or above it) and
    AdamW through K-norm and K-adamw against the plain code on the card:
    leaves of 1, 7, 4099 and 2**20 + 3 elements (tails past the last
    16-byte vector, a leaf of 33 chunks) and one one element past a 16-byte
    boundary (the element path). K-norm's norm (``global_norm`` on the
    card) within 1e-6 relative of the plain sum of squares. Both updates
    then take the plain norm, so that the two paths part only where their
    arithmetic does: ``optim.adamw_`` (K-adamw) against ``optim.adamw_plain_``
    on the card, p and nu within 4 f32 ulps, mu within one ulp of its dtype,
    at the size of the operands of their last rounding; both leave g as it
    was."""
    from mpi_operator_tpu_torch.kernels import optim
    from mpi_operator_tpu_torch.ops.trainer import global_norm

    _need_card()
    beta1, beta2 = 0.9, 0.95

    def update_(update, params, grads, opt, count, norm):
        leaves = {n: (p, grads[n], opt["mu"][n], opt["nu"][n]) for n, p in params.items()}
        update(leaves, norm, 1.0, OPT_LR, beta1, beta2, 1.0 - beta1 ** count,
               1.0 - beta2 ** count, 1e-8, wd)

    kp, kopt = _opt_state(mu_bf16)
    pp, popt = _opt_state(mu_bf16)
    for step in range(3):
        before = {n: (pp[n].clone(), popt["mu"][n].float() * beta1) for n in pp}
        kg, pg = _opt_grads(kp, step, target), _opt_grads(pp, step, target)
        kept = {n: g.clone() for n, g in kg.items()}
        knorm = global_norm(list(kg.values()))
        pnorm = torch.sqrt(optim.sum_squares_plain(pg.values()))
        update_(optim.adamw_plain_, pp, pg, popt, step + 1, pnorm)
        update_(optim.adamw_, kp, kg, kopt, step + 1, pnorm)
        assert (float(pnorm) < 1.0) == (target < 1.0)
        np.testing.assert_allclose(float(knorm), float(pnorm), rtol=1e-6)
        for n in kp:
            assert torch.equal(kg[n], kept[n]), f"{n}: K-adamw wrote g"
            p0, mb = before[n]
            _assert_ulps(kp[n], pp[n], torch.maximum(p0.abs(), pp[n].abs()), 4,
                         f"p of {n}, step {step}")
            _assert_ulps(kopt["nu"][n], popt["nu"][n], popt["nu"][n], 4,
                         f"nu of {n}, step {step}")
            factor = torch.where(pnorm < 1.0, torch.ones_like(pnorm), 1.0 / pnorm)
            g_scale = (1 - beta1) * (pg[n] * factor).abs()
            _assert_ulps(kopt["mu"][n], popt["mu"][n], torch.maximum(mb.abs(), g_scale), 1,
                         f"mu of {n}, step {step}")


@pytest.mark.cuda
def test_optimizer_kernels_refuse_split_launches_and_count(monkeypatch):
    """K-adamw refuses a leaf stored column-major or strided (every other
    element of a buffer) before writing anything. With two leaves a launch
    the results are bitwise those of one launch, in as many launches as
    planned. A train step of a small Llama on the card launches K-norm, its
    finish and K-adamw once each."""
    from mpi_operator_tpu_torch.kernels import optim
    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.ops.data import make_global_batch
    from mpi_operator_tpu_torch.ops.trainer import Trainer, TrainerConfig, global_norm

    _need_card()

    def adamw_(params, grads, opt, norm):
        leaves = {n: (p, grads[n], opt["mu"][n], opt["nu"][n]) for n, p in params.items()}
        optim.adamw_(leaves, norm, 1.0, OPT_LR, 0.9, 0.95, 0.1, 0.05, 1e-8, 0.0)

    def leaves(bad=None):
        gen = torch.Generator(device="cuda").manual_seed(3)
        params = {"vector": torch.randn(4099, generator=gen, device="cuda"),
                  "matrix": torch.randn(33, 64, generator=gen, device="cuda"),
                  "big": torch.randn(3 * optim.CHUNK + 5, generator=gen, device="cuda")}
        if bad == "colmajor":
            params[bad] = torch.randn(33, 64, generator=gen, device="cuda").t()
        elif bad == "strided":
            params[bad] = torch.randn(1026, generator=gen, device="cuda")[::2]
        opt = {"mu": {n: torch.zeros_like(p, dtype=torch.bfloat16) for n, p in params.items()},
               "nu": {n: torch.zeros_like(p) for n, p in params.items()}}
        grads = {n: torch.randn(p.shape, generator=gen, device="cuda") for n, p in params.items()}
        return params, grads, opt

    for bad in ("colmajor", "strided"):
        params, grads, opt = leaves(bad)
        norm = torch.ones((), device="cuda")
        kept = {n: p.clone() for n, p in params.items()}
        with pytest.raises(ValueError, match=f"K-adamw cannot take leaf {bad}"):
            adamw_(params, grads, opt, norm)
        assert all(torch.equal(params[n], kept[n]) for n in params)

    def run():
        params, grads, opt = leaves()
        optim.reset_launches()
        norm = global_norm(list(grads.values()))
        adamw_(params, grads, opt, norm)
        return norm, params, opt, dict(optim.launches)

    norm, params, opt, launches = run()
    assert launches == {"sumsq": 1, "sumsq_finish": 1, "adamw": 1}
    monkeypatch.setitem(optim._capacity, "norm", 2)
    monkeypatch.setitem(optim._capacity, "adamw", 2)
    norm2, params2, opt2, launches2 = run()
    assert launches2 == {"sumsq": 2, "sumsq_finish": 1, "adamw": 2}
    assert torch.equal(norm, norm2)
    for n in params:
        assert torch.equal(params[n], params2[n]), n
        assert torch.equal(opt["mu"][n], opt2["mu"][n]) and torch.equal(opt["nu"][n],
                                                                        opt2["nu"][n]), n
    monkeypatch.undo()

    model = llama.init(llama.tiny(), torch.Generator(device="cuda").manual_seed(0), "cuda")
    step_trainer = Trainer(llama.loss_fn, TrainerConfig(learning_rate=1e-3, adam_mu_bf16=True))
    state = step_trainer.init_state(model)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)
    batch = make_global_batch({"tokens": tokens}, "cuda")
    optim.reset_launches()
    step_trainer.train_step(state, batch)
    assert optim.launches == {"sumsq": 1, "sumsq_finish": 1, "adamw": 1}


# ---------------------------------------------------------------------------
# K-rms: the models' RMSNorm (csrc/rmsnorm.cu) against its plain version
# (kernels/rmsnorm.py) on the same card
# ---------------------------------------------------------------------------

# (D, x heads-major): QK-norm's 128 and the tiny configurations' 16 and 64 on
# the einsum's [B, H, T, Dh] view of [B, T, H, Dh] storage, the hidden sizes
# 2048 and 4096 on [B, T, D]
RMS_CASES = [(16, True), (64, True), (128, True), (2048, False), (4096, False)]
RMS_EPS = 1e-5


def _rms_inputs(d, dtype, heads_major, seed=0):
    """x (rows of magnitudes spread over e^±2), a contiguous dy and an f32
    scale near 1."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if heads_major:
        x = torch.randn(2, 300, 8, d, generator=gen, device="cuda").permute(0, 2, 1, 3)
    else:
        x = torch.randn(3, 257, d, generator=gen, device="cuda")
    x = (x * torch.exp(torch.randn(x.shape[:-1] + (1,), generator=gen, device="cuda"))).to(dtype)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    return x, dy, scale


def _rms_plain_grads(x, dy, scale):
    from mpi_operator_tpu_torch.kernels import rmsnorm as krms

    xl = x.detach().clone().requires_grad_(True)
    sl = scale.detach().clone().requires_grad_(True)
    y = krms.rmsnorm_plain(xl, sl, RMS_EPS)
    y.backward(dy)
    return y.detach(), xl.grad, sl.grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d,heads_major", RMS_CASES)
def test_rmsnorm_kernels_match_plain(d, heads_major, dtype):
    """K-rms's forward and backward against ``rmsnorm_plain`` (autograd
    through the eager passes) on the card. Bounds, each from where the two
    part:

    - y within 1 ulp of its dtype (f32: 16 ulps): the same f32 arithmetic
      but the order of the row's sum of squares, which moves rstd by a few
      f32 ulps; y's one rounding to bf16 can then land a ulp apart;
    - dx within 1 ulp of its dtype plus 32 f32 ulps of the size of its
      operands, rstd · (|g| + |x̂| · Σ|g · x̂| / D): the row's Σ g · x̂ is
      taken in another order and dx = rstd · (g − x̂ · mean) can cancel;
    - dscale within 1e-5 of Σ_rows |dy · x̂| in each column: two f32 sums of
      the same products in different orders, each within a few 1e-7 of that
      sum of magnitudes at these row counts.

    The output keeps x's strides; a second backward gives the same bits."""
    from mpi_operator_tpu_torch.kernels import rmsnorm as krms

    _need_card()
    x, dy, scale = _rms_inputs(d, dtype, heads_major)
    y_ref, dx_ref, ds_ref = _rms_plain_grads(x, dy, scale)
    krms.reset_launches()
    y, rstd = krms.rms_fwd_cuda(x, scale, RMS_EPS)
    dx, dscale = krms.rms_bwd_cuda(x, dy, scale, rstd)
    dx2, dscale2 = krms.rms_bwd_cuda(x, dy, scale, rstd)
    torch.cuda.synchronize()
    assert krms.launches == {"rms_fwd": 1, "rms_bwd": 2, "rms_bwd_finish": 2}
    assert y.stride() == x.stride() and dx.stride() == x.stride()
    assert y.dtype == dx.dtype == dtype and dscale.dtype == torch.float32
    assert torch.equal(dx, dx2) and torch.equal(dscale, dscale2)
    n_y = 1 if dtype == torch.bfloat16 else 16
    _assert_ulps(y, y_ref, y_ref, n_y, f"y at D {d}")
    _assert_rms_backward(x, dy, scale, dx, dscale, dx_ref, ds_ref)


def _assert_rms_backward(x, dy, scale, dx, dscale, dx_ref, ds_ref):
    """dx and dscale against the plain version's, under the bounds that
    ``test_rmsnorm_kernels_match_plain`` states."""
    d = x.shape[-1]
    x32 = x.float()
    rs = torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + RMS_EPS)
    xh = x32 * rs
    g = dy.float() * scale
    size = rs * (g.abs() + xh.abs() * (g * xh).abs().sum(-1, keepdim=True) / d)
    err = (dx.float() - dx_ref.float()).abs()
    tol = 32 * _ulp(size, torch.float32)
    if x.dtype == torch.bfloat16:
        tol = tol + _ulp(torch.maximum(dx.float().abs(), dx_ref.float().abs()), x.dtype)
    assert float((err / tol).max()) <= 1.0, f"dx at D {d}: {float((err / tol).max()):.3f}"
    magnitude = (dy.float() * xh).abs().reshape(-1, d).sum(0)
    assert float(((dscale - ds_ref).abs() / magnitude).max()) <= 1e-5, f"dscale at D {d}"


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads_major", [(128, True), (4096, False)])
def test_rmsnorm_takes_a_broadcast_gradient(d, heads_major):
    """``rmsnorm(x, scale).sum().backward()`` on the card: autograd hands the
    Function a broadcast dy (stride 0), which goes to the kernel as one
    contiguous copy; dx and dscale as the plain version's, under the bounds
    of ``test_rmsnorm_kernels_match_plain``."""
    from mpi_operator_tpu_torch.kernels import rmsnorm as krms

    _need_card()
    x, _, scale = _rms_inputs(d, torch.bfloat16, heads_major)
    ones = torch.ones_like(x)
    _, dx_ref, ds_ref = _rms_plain_grads(x, ones, scale)
    xl = x.detach().clone().requires_grad_(True)
    sl = scale.detach().clone().requires_grad_(True)
    krms.reset_launches()
    krms.rmsnorm(xl, sl, RMS_EPS).sum().backward()
    torch.cuda.synchronize()
    assert krms.launches == {"rms_fwd": 1, "rms_bwd": 1, "rms_bwd_finish": 1}
    _assert_rms_backward(x, ones, scale, xl.grad, sl.grad, dx_ref, ds_ref)


def _rms_step_model(name):
    import dataclasses

    from mpi_operator_tpu_torch.models import afmoe, llama

    if name == "afmoe":  # bf16 and D 64: the flash kernels' types and windowed widths
        return afmoe, dataclasses.replace(afmoe.tiny(), compute_dtype=torch.bfloat16,
                                          head_dim=64, remat_layers=True)
    if name == "llama-f32":  # f32 norms; attention by the dense oracle
        return llama, dataclasses.replace(llama.tiny(), compute_dtype=torch.float32,
                                          attention_impl="dense")
    return llama, dataclasses.replace(llama.tiny(), remat_layers=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama", "llama-f32", "afmoe"])
def test_a_train_step_normalises_through_k_rms(monkeypatch, name):
    """One train step of a tiny model on the card: every norm call launches
    rms_fwd once (the forward, and again in the remat's recompute), every
    norm of the backward rms_bwd and its finish once, and the plain version
    never runs. Llama: 2 norms a layer and the final one; AFMoE: 6 a layer
    (QK-norm at D 64) and the final one."""
    from mpi_operator_tpu_torch.kernels import rmsnorm as krms
    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.ops.data import make_global_batch
    from mpi_operator_tpu_torch.ops.trainer import Trainer, TrainerConfig

    _need_card()

    def refuse(*args, **kwargs):
        raise AssertionError("the plain norm ran for CUDA tensors")

    monkeypatch.setattr(krms, "rmsnorm_plain", refuse)
    module, cfg = _rms_step_model(name)
    model = module.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    trainer = Trainer(llama.loss_fn, TrainerConfig(learning_rate=1e-3))
    state = trainer.init_state(model)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    batch = make_global_batch({"tokens": tokens}, "cuda")
    krms.reset_launches()
    _, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    per_layer = 6 if name == "afmoe" else 2
    norms = per_layer * cfg.n_layers + 1
    again = per_layer * cfg.n_layers if cfg.remat_layers else 0
    assert krms.launches == {"rms_fwd": norms + again, "rms_bwd": norms,
                             "rms_bwd_finish": norms}
    assert np.isfinite(float(metrics["loss"]))
