"""RMSNorm (``kernels/rmsnorm.py``) on the CPU: no CUDA is needed to run the
plain version, to plan the rows and launch shape the kernels take, or to
see what they refuse.

- on CPU tensors ``rmsnorm`` (and ``llama._rmsnorm``, which both models
  call) is the models' RMSNorm as it stood before the kernels, bit for bit,
  in y, dx and dscale, contiguous, in the einsum's heads-major view and
  with a dy laid out otherwise than x;
- ``row_plan`` merges what leading dimensions it can and passes the rest
  as up to three strides an operand; it refuses by name a last dimension of
  stride other than 1, rows that overlap, D not a multiple of 8 or above
  ``MAX_D``, a row that does not start 16-byte aligned, and more than three
  leading dimensions;
- ``launch_shape`` puts several rows in a warp at small D and spreads a row
  over warps at large D, within one CTA, for every D the kernels take;
- the kernels' entry points refuse, before loading or launching anything,
  x, dy or a scale they cannot take; a CPU step of either model never calls
  them.

The kernels themselves are held to the plain version on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.kernels import rmsnorm as krms
from mpi_operator_tpu_torch.models import afmoe, llama


def _rmsnorm_before(x, scale, eps: float):
    """``models/llama._rmsnorm`` as it stood before the kernels."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def _layout(name, dtype, seed=0):
    """(x, dy) of one layout: ``contiguous`` [B, T, D]; ``heads_major`` x
    the einsum's [B, H, T, Dh] view of [B, T, H, Dh] storage and dy
    contiguous; ``dy_strided`` the other way round."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dtype)

    if name == "contiguous":
        return rnd(2, 5, 64), rnd(2, 5, 64)
    if name == "heads_major":
        return rnd(2, 5, 4, 16).permute(0, 2, 1, 3), rnd(2, 4, 5, 16)
    return rnd(2, 4, 5, 16), rnd(2, 5, 4, 16).permute(0, 2, 1, 3)


def _forward_backward(norm, x, dy, scale):
    x = x.detach().clone().requires_grad_(True)  # clone keeps a dense view's strides
    scale = scale.detach().clone().requires_grad_(True)
    y = norm(x, scale, 1e-5)
    y.backward(dy)
    return y, x.grad, scale.grad


@pytest.mark.parametrize("layout", ["contiguous", "heads_major", "dy_strided"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cpu_rmsnorm_is_the_models_norm_bit_for_bit(dtype, layout):
    x, dy = _layout(layout, dtype)
    d = x.shape[-1]
    scale = 1.0 + 0.1 * torch.randn(d, generator=torch.Generator().manual_seed(1))
    want = _forward_backward(_rmsnorm_before, x, dy, scale)
    for norm in (krms.rmsnorm, llama._rmsnorm):
        got = _forward_backward(norm, x, dy, scale)
        for g, w, what in zip(got, want, ("y", "dx", "dscale")):
            assert g.dtype == w.dtype and g.shape == w.shape, what
            assert torch.equal(g, w), f"{what} of {norm.__module__}"


def _plan(**tensors):
    shape = next(iter(tensors.values())).shape
    return krms.row_plan(shape, krms._operands(**tensors))


@pytest.mark.parametrize("layout,rows,n1,n2,strides", [
    ("contiguous", 10, 1, 10, {"x": (0, 0, 64), "y": (0, 0, 64), "dy": (0, 0, 64)}),
    ("heads_major", 40, 4, 5, {"x": (320, 16, 64), "y": (320, 16, 64), "dy": (320, 80, 16)}),
    ("dy_strided", 40, 4, 5, {"x": (320, 80, 16), "y": (320, 80, 16), "dy": (320, 16, 64)}),
])
def test_row_plan_passes_each_operands_strides(layout, rows, n1, n2, strides):
    """The rows and strides the kernels get: the contiguous [B, T, D] one
    leading dimension; the heads-major view (storage [B, T, H, Dh]) three,
    y with x's strides (``empty_like``), dy with its own."""
    x, dy = _layout(layout, torch.bfloat16)
    y = torch.empty_like(x)
    assert y.stride() == x.stride()
    plan = _plan(x=x, y=y, dy=dy)
    assert (plan.rows, plan.n1, plan.n2, plan.d) == (rows, n1, n2, x.shape[-1])
    assert dict(plan.strides) == strides
    for name, t in (("x", x), ("dy", dy)):  # row r starts where t's row r does
        s = plan.strides[name]
        got = [(r // (n1 * n2)) * s[0] + (r // n2 % n1) * s[1] + (r % n2) * s[2]
               for r in range(rows)]
        offsets = torch.as_strided(torch.arange(t.numel()), t.shape, t.stride())
        assert got == offsets[..., 0].reshape(-1).tolist(), name


def test_row_plan_drops_unit_dimensions_and_takes_a_vector():
    assert _plan(x=torch.zeros(1, 3, 1, 16)) == krms.RowPlan(
        rows=3, n1=1, n2=3, d=16, strides={"x": (0, 0, 16)})
    assert _plan(x=torch.zeros(24)) == krms.RowPlan(rows=1, n1=1, n2=1, d=24,
                                                    strides={"x": (0, 0, 0)})


def _misaligned_start():
    return torch.zeros(1 + 4 * 16, dtype=torch.bfloat16)[1:].view(4, 16)


@pytest.mark.parametrize("case,make,match", [
    ("last stride 2", lambda: torch.zeros(4, 16, 2)[..., 0], "stride 1 in its last"),
    ("broadcast rows", lambda: torch.zeros(16).expand(4, 16), "do not overlap"),
    ("rows 8 apart", lambda: torch.zeros(64).as_strided((4, 16), (8, 1)), "do not overlap"),
    ("D 12", lambda: torch.zeros(4, 12), "multiple of 8"),
    ("D 8200", lambda: torch.zeros(2, 8200), "multiple of 8 from 8 to 8192"),
    ("misaligned start", _misaligned_start, "16-byte aligned"),
    ("rows 40 bytes apart", lambda: torch.zeros(4, 20, dtype=torch.bfloat16)[:, :16],
     "16-byte aligned"),
    ("four leading dims", lambda: torch.zeros(2, 3, 4, 5, 16).permute(1, 0, 3, 2, 4),
     "at most three leading"),
])
def test_row_plan_refuses_by_name(case, make, match):
    with pytest.raises(ValueError, match=f"K-rms .*{match}|{match}"):
        _plan(x=make())


@pytest.mark.parametrize("d,itemsize,backward,want", [
    (8, 2, False, (1, 1)),
    (16, 2, False, (2, 1)),
    (16, 4, False, (4, 1)),
    (64, 2, False, (4, 2)),
    (128, 2, False, (4, 4)),
    (128, 2, True, (2, 8)),
    (2048, 2, False, (4, 64)),
    (2048, 2, True, (2, 128)),
    (4096, 2, False, (4, 128)),
    (4096, 2, True, (2, 256)),
    (8192, 2, True, (4, 256)),
    (8192, 4, False, (8, 256)),
])
def test_launch_shape_adapts_to_d(d, itemsize, backward, want):
    """(vectors a thread, threads a row): QK-norm's 128 puts 8 rows (4
    backward) in a warp, the hidden sizes 2048 and 4096 spread a row over 2
    to 8 warps, and the widest rows take more vectors a thread."""
    assert krms.launch_shape(d, itemsize, backward) == want


def test_launch_shape_covers_every_row_in_one_cta():
    for itemsize in (2, 4):
        for backward in (False, True):
            for d in range(8, krms.MAX_D + 1, 8):
                vpt, tpr = krms.launch_shape(d, itemsize, backward)
                nvec = d * itemsize // krms.VECTOR_BYTES
                assert vpt in (1, 2, 4, 8) and tpr & (tpr - 1) == 0 and tpr <= krms.BLOCK
                assert nvec <= vpt * tpr < 2 * nvec + vpt, (d, itemsize, backward)


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError("the library was loaded before a refusal")

    monkeypatch.setattr(krms, "load", refuse)
    krms.reset_launches()
    yield
    assert krms.launches == {"rms_fwd": 0, "rms_bwd": 0, "rms_bwd_finish": 0}


def _fwd(x, scale=None):
    krms.rms_fwd_cuda(x, torch.ones(x.shape[-1]) if scale is None else scale, 1e-5)


def _bwd(x, dy=None, scale=None, rstd=None):
    rows = x.numel() // x.shape[-1]
    krms.rms_bwd_cuda(x, torch.zeros_like(x) if dy is None else dy,
                      torch.ones(x.shape[-1]) if scale is None else scale,
                      torch.ones(rows) if rstd is None else rstd)


@pytest.mark.parametrize("case,call,match", [
    ("fwd: f16 x", lambda: _fwd(torch.zeros(4, 16, dtype=torch.float16)), "bf16 or f32"),
    ("fwd: bf16 scale", lambda: _fwd(torch.zeros(4, 16), torch.ones(16, dtype=torch.bfloat16)),
     "f32 scale"),
    ("fwd: scale of 8", lambda: _fwd(torch.zeros(4, 16), torch.ones(8)), "f32 scale of 16"),
    ("fwd: D 12", lambda: _fwd(torch.zeros(4, 12)), "multiple of 8"),
    ("fwd: broadcast rows", lambda: _fwd(torch.zeros(16).expand(4, 16)), "overlap"),
    ("fwd: last stride 2", lambda: _fwd(torch.zeros(4, 16, 2)[..., 0]), "stride 1"),
    ("fwd: misaligned", lambda: _fwd(_misaligned_start()), "aligned"),
    ("fwd: a CPU tensor", lambda: _fwd(torch.zeros(4, 16)), "one CUDA device"),
    ("bwd: dy of another dtype", lambda: _bwd(torch.zeros(4, 16),
                                              torch.zeros(4, 16, dtype=torch.bfloat16)),
     "dy of x's dtype"),
    ("bwd: rstd of 3 rows", lambda: _bwd(torch.zeros(4, 16), rstd=torch.ones(3)),
     "rstd, 4 contiguous"),
    ("bwd: overlapping x", lambda: _bwd(torch.zeros(16).expand(4, 16)), "overlap"),
    ("bwd: a broadcast dy", lambda: _bwd(torch.zeros(4, 16), torch.ones(()).expand(4, 16)),
     "dy with stride 1"),
    ("bwd: dy rows 8 apart", lambda: _bwd(torch.zeros(4, 16),
                                          torch.zeros(64).as_strided((4, 16), (8, 1))),
     "dy with rows that do not overlap"),
    ("bwd: a CPU tensor", lambda: _bwd(torch.zeros(4, 16)), "one CUDA device"),
])
def test_the_kernels_refuse_before_any_launch(no_library, case, call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("layout", ["broadcast", "heads-major"])
def test_the_backward_hands_the_kernel_dense_rows(monkeypatch, layout):
    """The autograd Function gives ``rms_bwd_cuda`` a contiguous copy of a
    broadcast dy (the gradient of ``y.sum()``), whose rows the kernel would
    refuse as overlapping, and any other dy as it is, with no copy."""
    x = torch.randn(2, 3, 5, 16)
    if layout == "broadcast":
        dy = torch.ones(()).expand(x.shape)
    else:
        dy = torch.randn(2, 5, 3, 16).transpose(1, 2)
    seen = []

    def bwd(x_, dy_, scale_, rstd_):
        seen.append(dy_)
        return torch.zeros_like(x_), torch.zeros_like(scale_)

    monkeypatch.setattr(krms, "rms_bwd_cuda", bwd)
    ctx = type("Ctx", (), {"saved_tensors": (x, torch.ones(16), torch.ones(30))})()
    krms._RMSNorm.backward(ctx, dy)
    (got,) = seen
    assert torch.equal(got, dy)
    if layout == "broadcast":
        assert got.is_contiguous()
        krms.row_plan(x.shape, {"dy": (got.stride(), got.data_ptr(), got.element_size())})
    else:
        assert got is dy


@pytest.mark.parametrize("module", [llama, afmoe], ids=["llama", "afmoe"])
def test_cpu_steps_take_the_plain_norm(monkeypatch, module):
    """A CPU forward and backward of either tiny model normalises through
    ``rmsnorm_plain`` alone: the kernels' entry points are never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("K-rms ran for CPU tensors")

    for fn in ("load", "rms_fwd_cuda", "rms_bwd_cuda"):
        monkeypatch.setattr(krms, fn, refuse)
    calls = []
    plain = krms.rmsnorm_plain

    def counted(x, scale, eps):
        calls.append(x.shape[-1])
        return plain(x, scale, eps)

    monkeypatch.setattr(krms, "rmsnorm_plain", counted)
    cfg = module.tiny()
    model = module.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    llama.loss_fn(model, {"tokens": torch.from_numpy(tokens)}).backward()
    per_layer = 2 if module is llama else 6
    assert len(calls) == per_layer * cfg.n_layers + 1
