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
# the optimizer phase: K-norm and K-adamw (csrc/optim.cu) against the plain
# clip_by_global_norm_ and Trainer._adamw on the same card
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
    arithmetic does: ``Trainer._adamw_kernels`` against the plain
    ``Trainer._adamw`` after ``scale_by_clip_``, p and nu within 4 f32 ulps, mu
    within one ulp of its dtype, at the size of the operands of their last
    rounding; the kernels leave g as it was."""
    from mpi_operator_tpu_torch.ops.trainer import (Trainer, TrainerConfig, global_norm,
                                                    scale_by_clip_)

    _need_card()
    trainer = Trainer(lambda m, b: 0.0, TrainerConfig(learning_rate=OPT_LR, weight_decay=wd,
                                                      adam_mu_bf16=mu_bf16))
    kp, kopt = _opt_state(mu_bf16)
    pp, popt = _opt_state(mu_bf16)
    for step in range(3):
        before = {n: (pp[n].clone(), popt["mu"][n].float() * trainer.config.beta1)
                  for n in pp}
        kg, pg = _opt_grads(kp, step, target), _opt_grads(pp, step, target)
        kept = {n: g.clone() for n, g in kg.items()}
        knorm = global_norm(list(kg.values()))
        pnorm = torch.sqrt(sum(g.float().pow(2).sum() for g in pg.values()))
        scale_by_clip_(list(pg.values()), pnorm, 1.0)
        trainer._adamw(pp, pg, popt, step + 1, OPT_LR)
        trainer._adamw_kernels(kp, kg, kopt, step + 1, OPT_LR, pnorm)
        assert (float(pnorm) < 1.0) == (target < 1.0)
        np.testing.assert_allclose(float(knorm), float(pnorm), rtol=1e-6)
        for n in kp:
            assert torch.equal(kg[n], kept[n]), f"{n}: K-adamw wrote g"
            p0, mb = before[n]
            _assert_ulps(kp[n], pp[n], torch.maximum(p0.abs(), pp[n].abs()), 4,
                         f"p of {n}, step {step}")
            _assert_ulps(kopt["nu"][n], popt["nu"][n], popt["nu"][n], 4,
                         f"nu of {n}, step {step}")
            g_scale = (1 - trainer.config.beta1) * pg[n].abs()
            _assert_ulps(kopt["mu"][n], popt["mu"][n], torch.maximum(mb.abs(), g_scale), 1,
                         f"mu of {n}, step {step}")


@pytest.mark.cuda
def test_optimizer_kernels_refuse_split_launches_and_count(monkeypatch):
    """K-adamw refuses a leaf stored column-major or strided (every other
    element of a buffer) before writing anything. With two leaves a launch
    the results
    are bitwise those of one launch, in as many launches as planned. A
    captured train step of a small Llama on the card launches K-norm, its
    finish and K-adamw once each and counts every element as K-adamw's."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_operator_tpu_torch.kernels import optim
    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.ops.data import make_global_batch
    from mpi_operator_tpu_torch.ops.trainer import Trainer, TrainerConfig, global_norm
    from mpi_operator_tpu_torch.runtime import stepstats

    _need_card()
    trainer = Trainer(lambda m, b: 0.0, TrainerConfig(learning_rate=OPT_LR, adam_mu_bf16=True))

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
            trainer._adamw_kernels(params, grads, opt, 1, OPT_LR, norm)
        assert all(torch.equal(params[n], kept[n]) for n in params)

    def run():
        params, grads, opt = leaves()
        optim.reset_launches()
        norm = global_norm(list(grads.values()))
        trainer._adamw_kernels(params, grads, opt, 1, OPT_LR, norm)
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
    stepstats.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            step_trainer.train_step(state, batch)
        counters = stepstats.counter_totals()["counters"]
    finally:
        stepstats.reset_counters()
    n = sum(p.numel() for p in model.parameters())
    assert optim.launches == {"sumsq": 1, "sumsq_finish": 1, "adamw": 1}
    assert counters == {"trainer.update.fused": float(n), "trainer.update.plain": 0.0}
