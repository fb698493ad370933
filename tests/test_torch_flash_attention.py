"""The PyTorch port's flash attention against the JAX package's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU (as in
test_flash_attention.py); the port's CPU path is the plain version of each
CUDA kernel. Inputs are drawn with numpy and fed to both.

Tolerances (the JAX suite's): f32 forward 2e-5, f32 gradients 5e-4, bf16
3e-2. bf16 differs by rounding points the two frameworks place apart (the
port sums K3's group in f32, the Pallas wrapper sums bf16 partials).
"""

import importlib
import importlib.util
import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.kernels import flash_attention as tfa
from mpi_operator_tpu_torch.parallel.ring_attention import dense_attention

# the JAX package's kernels/__init__ re-exports the function under the
# module's name, so import the module by its path
jfa = importlib.import_module("mpi_operator_tpu.kernels.flash_attention")

F32_FWD, F32_GRAD, BF16 = 2e-5, 5e-4, 3e-2


def _arrays(seed, b, t, h, h_kv, d):
    """q, k, v, dO heads-major [B,H,T,D] as f32 numpy."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, t, d), np.float32),
        rng.standard_normal((b, h_kv, t, d), np.float32),
        rng.standard_normal((b, h_kv, t, d), np.float32),
        rng.standard_normal((b, h, t, d), np.float32),
    )


def _jax(x, dtype):
    return jnp.asarray(x, jnp.float32).astype(dtype)


def _torch(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "causal,dtype,t,h,h_kv,block",
    [
        (True, "f32", 96, 4, 2, 64),  # GQA, ragged T against 64-blocks
        (False, "f32", 96, 4, 2, 64),
        (True, "f32", 64, 4, 4, 32),  # MHA, T a block multiple
        (True, "bf16", 96, 4, 2, 64),
        (False, "bf16", 96, 4, 2, 64),
        # the CUDA K1's tiles (128 x 128), two q tiles, ragged T
        (True, "f32", 200, 4, 2, (128, 128)),
        (False, "f32", 200, 4, 2, (128, 128)),
        (True, "bf16", 200, 4, 2, (128, 128)),
        # block_q = 2 * block_k: a q tile spans two k tiles of the causal bound
        (True, "f32", 200, 4, 2, (128, 64)),
        (True, "f32", 129, 4, 4, (128, 64)),
        (False, "bf16", 200, 8, 1, (128, 64)),
    ],
)
def test_plain_kernels_match_pallas(causal, dtype, t, h, h_kv, block):
    block_q, block_k = block if isinstance(block, tuple) else (block, block)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    q, k, v, do = _arrays(0, 1, t, h, h_kv, 16)
    scale = 16 ** -0.5
    jq, jk, jv, jdo = (_jax(x, jdt) for x in (q, k, v, do))
    jo, jlse = jfa._flash_fwd(
        jq, jk, jv, causal=causal, scale=scale, block_q=block_q, block_k=block_k, interpret=True
    )
    jdq, jdk, jdv = jfa._flash_bwd(
        jq, jk, jv, jo, jlse, jdo, causal=causal, scale=scale,
        block_q=block_q, block_k=block_k, interpret=True,
    )
    tq, tk, tv, tdo = (_torch(x, tdt) for x in (q, k, v, do))
    o, lse = tfa.flash_fwd_plain(tq, tk, tv, causal, scale, block_q=block_q, block_k=block_k)
    assert o.dtype == tdt and lse.dtype == torch.float32 and lse.shape == (1, h, t)
    fwd_tol = F32_FWD if dtype == "f32" else BF16
    _close(o, jo, fwd_tol)
    _close(lse, np.asarray(jlse)[:, :, :t, 0], fwd_tol)

    # the backward kernels on the JAX side's own o/lse, so each is held alone
    lse_j = _torch(np.asarray(jlse)[:, :, :t, 0], torch.float32)
    o_j = _torch(_np(jo), tdt)
    delta = (tdo.float() * o_j.float()).sum(-1)
    args = (tq, tk, tv, tdo, lse_j, delta, causal, scale)
    dq, dk, dv = tfa.flash_bwd_plain(*args)
    grad_tol = F32_GRAD if dtype == "f32" else BF16
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == tdt and got.shape == want.shape
        _close(got, want, grad_tol)


@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
def test_flash_attention_autograd_matches_jax(layout):
    q, k, v, do = _arrays(1, 2, 80, 4, 2, 16)
    if layout == "bthd":
        q, k, v, do = (x.transpose(0, 2, 1, 3) for x in (q, k, v, do))

    def jloss(q_, k_, v_):
        o = jfa.flash_attention(
            q_, k_, v_, causal=True, block_q=32, block_k=32, interpret=True, layout=layout
        )
        return jnp.sum(o * jnp.asarray(do)), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v))
    )
    tq, tk, tv = (_torch(x, torch.float32).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=True, block_q=32, block_k=32, layout=layout)
    tgrads = torch.autograd.grad(o, (tq, tk, tv), _torch(do, torch.float32))
    _close(o, jo, F32_FWD)
    for got, want in zip(tgrads, jgrads):
        _close(got, want, F32_GRAD)


def test_flash_attention_bf16_autograd_matches_dense():
    """bf16 through the autograd path against the f32 dense oracle."""
    q, k, v, do = (x.transpose(0, 2, 1, 3) for x in _arrays(2, 1, 72, 4, 2, 16))
    tq, tk, tv = (_torch(x, torch.bfloat16).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=True)
    grads = torch.autograd.grad(o, (tq, tk, tv), _torch(do, torch.bfloat16))
    rq, rk, rv = (_torch(x, torch.float32).requires_grad_() for x in (q, k, v))
    ref = dense_attention(rq, rk, rv, causal=True, scale=16 ** -0.5)
    ref_grads = torch.autograd.grad(ref, (rq, rk, rv), _torch(do, torch.float32))
    assert o.dtype == torch.bfloat16
    _close(o, ref, BF16)
    for got, want in zip(grads, ref_grads):
        assert got.dtype == torch.bfloat16
        _close(got, want, BF16)


@pytest.mark.parametrize("causal", [True, False])
def test_references_match_jax(causal):
    """The port's chunked and dense references against the JAX ones (plain
    XLA on both sides), in model layout."""
    q, k, v, _ = (x.transpose(0, 2, 1, 3) for x in _arrays(3, 2, 50, 4, 2, 16))
    want = jfa.chunked_reference(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, block_q=16)
    got = tfa.chunked_reference(*(_torch(x, torch.float32) for x in (q, k, v)),
                                causal=causal, block_q=16)
    _close(got, want, F32_FWD)
    dense = tfa._dense_reference(
        *(_torch(x, torch.float32).transpose(1, 2) for x in (q, k, v)), causal=causal,
        scale=0.25,
    )
    _close(dense.transpose(1, 2), want, F32_FWD)
    from mpi_operator_tpu.parallel.ring_attention import dense_attention as jdense

    _close(
        dense_attention(*(_torch(x, torch.float32) for x in (q, k, v)), causal=causal, scale=0.25),
        jdense(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, scale=0.25),
        F32_FWD,
    )


def test_causal_tile_algebra_matches_jax():
    for bq, bk in ((64, 64), (32, 64), (64, 32), (48, 16)):
        for qi in range(8):
            assert tfa._causal_last_k_tile(qi, bq, bk) == jfa._causal_last_k_tile(qi, bq, bk)
            for ki in range(8):
                assert tfa._causal_open(qi, ki, bq, bk) == jfa._causal_open(qi, ki, bq, bk)
        for ki in range(8):
            assert tfa._causal_first_q_tile(ki, bq, bk) == jfa._causal_first_q_tile(ki, bq, bk)


def _compiled_constants():
    """The tile constants the CUDA source is compiled at."""
    src = os.path.join(os.path.dirname(tfa.__file__), "csrc", "flash_attention.cu")
    with open(src) as f:
        text = f.read()
    return {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_defaults_are_the_compiled_tiles():
    """flash_fwd, flash_attention and the plain K1 default to the tiles the
    CUDA K1 is compiled at, so the plain K1 walks K1's k tiles and is its
    exact arithmetic reference."""
    c = _compiled_constants()
    assert (tfa.BLOCK_Q, tfa.BLOCK_K) == (c["FWD_BQ"], c["FWD_BK"]) == (128, 128)
    for fn in (tfa.flash_fwd, tfa.flash_fwd_plain, tfa.flash_attention):
        params = inspect.signature(fn).parameters
        assert params["block_q"].default == c["FWD_BQ"], fn.__name__
        assert params["block_k"].default == c["FWD_BK"], fn.__name__


def test_wrappers_refuse_other_devices_and_bad_layout():
    q = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_fwd(q, q, q, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tfa.flash_fwd_cuda(*(torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16),) * 3, True, 1.0)
    with pytest.raises(ValueError, match="bf16"):
        tfa.flash_fwd_cuda(*(torch.zeros(1, 2, 8, 64),) * 3, True, 1.0)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd_cuda(*(torch.zeros(1, 2, 8, 48, dtype=torch.bfloat16),) * 3, True, 1.0)
    with pytest.raises(ValueError, match="layout"):
        tfa.flash_attention(q, q, q, layout="bthx")
    x = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tfa.flash_bwd_dkv_cuda(x, x, x, x, lse, lse, torch.zeros(x.shape), True, 1.0)


def _bwd_args(causal, g, dtype=torch.bfloat16):
    """A backward's inputs at ragged T (72: a partial last tile) and 2 kv
    heads, each with g q heads; lse and delta from the plain K1."""
    q, k, v, do = (_torch(x, dtype) for x in _arrays(4, 2, 72, 2 * g, 2, 16))
    scale = 16 ** -0.5
    o, lse = tfa.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    return (q, k, v, do, lse, delta, causal, scale)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_bwd_op_on_cpu_is_the_plain_backward(causal, g):
    """On CPU tensors the one backward operator returns exactly the plain
    dq, dk and dv, in the inputs' dtype and shapes."""
    args = _bwd_args(causal, g)
    got = tfa.flash_bwd_op(*args)
    want = tfa.flash_bwd_plain(*args)
    assert len(got) == 3
    for x, w, like in zip(got, want, args[:3]):
        assert x.dtype == like.dtype and x.shape == like.shape
        assert torch.equal(x, w)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_bwd_op_fake_gives_shapes_and_dtypes(causal, g):
    """The operator's fake (what shape propagation and compiled graphs see)
    gives dq like q and dk, dv like k and v, without running the kernels."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _bwd_args(causal, g)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(x) for x in args[:6]]
        dq, dk, dv = tfa.flash_bwd_op(*fake, causal, args[7])
    for x, like in zip((dq, dk, dv), args[:3]):
        assert x.shape == like.shape and x.dtype == like.dtype and x.device == like.device


class _OpLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the port's attention operators as the dispatcher sees them."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == tfa.OPS_NAMESPACE:
            self.ops.append(func._opname)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 4])
def test_backward_makes_one_backward_call(causal, g):
    """The autograd backward of flash attention and the ring's per-block
    backward each make one call to the one backward operator, with the
    forward's lse and the same delta, and nothing else of the port's."""
    from mpi_operator_tpu_torch.parallel import ring_attention as tra

    q, k, v, do, lse, delta, _, scale = _bwd_args(causal, g)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(qg, kg, vg, causal=causal, scale=scale, layout="bhtd")
    with _OpLog() as log:
        grads = torch.autograd.grad(o, (qg, kg, vg), do)
    assert log.ops == ["flash_bwd"]
    for x, w in zip(grads, tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)):
        assert torch.equal(x, w)
    with _OpLog() as log:
        got = tra.block_backward(q, k, v, do, lse, delta, causal, scale)
    assert log.ops == ["flash_bwd"] and len(got) == 3


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 4])
def test_smoke_plain_backward_by_head_is_the_plain_backward(causal, g):
    """chip_smoke.py holds the backward at the benchmark's shapes against
    the plain version run one q head at a time (over a whole kv head it
    would not fit the card). That is flash_bwd_plain's arithmetic: the same
    values but for the order of dk's and dv's f32 sums over the group, so
    within one bf16 ulp of each value."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    args = _bwd_args(causal, g)
    got = smoke._plain_bwd_by_head(*args)
    for x, w, like in zip(got, tfa.flash_bwd_plain(*args), args[:3]):
        assert x.dtype == like.dtype and x.shape == like.shape
        torch.testing.assert_close(x.float(), w.float(), rtol=2 ** -7,
                                   atol=1e-5 * float(w.float().abs().max()))
