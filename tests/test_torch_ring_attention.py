"""The port's ring attention against the JAX package's ring.

- ``ring_attention`` on gloo CPU gangs of ``sequence=2`` and ``4`` (fresh
  processes, tests/test_torch_sharded_step.py's ``run_ranks``), forward and
  gradients, causal and full, GQA 2:1, f32 and bf16, against JAX
  ``ring_attention(q, k, v, mesh)`` over the virtual CPU devices;
- the fold of every rank in one process (``fold_every_rank``, what the
  card's smoke drives) against K1–K3 over the whole T, on their plain
  versions;
- the plain version (the JAX ring's math in torch) against the JAX ring;
- without a ``sequence`` axis, ``ring_attention`` is ``flash_attention``.

Tolerances (the JAX flash suite's, tests/test_torch_flash_attention.py):
f32 forward 2e-5 and gradients 5e-4; bf16 3e-2 (the port rounds each
block's o and each block's dq/dk/dv share to bf16 before the f32 sums; the
JAX ring holds f32 throughout and rounds once).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sharded_step import gang, run_ranks  # noqa: E402

from mpi_operator_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from mpi_operator_tpu_torch.parallel import ring_attention as tra  # noqa: E402

B, T, H, HKV, D = 2, 64, 4, 2, 16
TOL = {"f32": (2e-5, 5e-4), "bf16": (3e-2, 3e-2)}
CASES = [(causal, dtype) for causal in (True, False) for dtype in ("f32", "bf16")]


def _inputs(seed=0, t=T):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, t, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, t, HKV, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, t, H, D)).astype(np.float32)
    return q, k, v, do


def _torch_dtype(dtype):
    return torch.float32 if dtype == "f32" else torch.bfloat16


def _rank(local_rank, args):
    import torch.distributed as dist

    from mpi_operator_tpu_torch.runtime import bootstrap

    n = args["n"]
    mesh = gang(local_rank, f"sequence={n}")
    i = dist.get_rank()
    out = {}
    for causal, dtype in CASES:
        blocks = [torch.from_numpy(x).to(_torch_dtype(dtype)).chunk(n, dim=1)[i].contiguous()
                  for x in _inputs()]
        q, k, v = (x.requires_grad_() for x in blocks[:3])
        o = tra.ring_attention(q, k, v, mesh, causal=causal)
        grads = torch.autograd.grad(o, (q, k, v), blocks[3])
        for name, x in zip(("o", "dq", "dk", "dv"), (o, *grads)):
            out[f"{causal}-{dtype}-{name}"] = x.detach().float().numpy()
    np.savez(os.path.join(args["dir"], f"rank{i}.npz"), **out)
    if i == 0:
        print(json.dumps({"ok": True}))
    bootstrap.shutdown()


def _jax_ring(n, causal, dtype, *, inputs=None):
    """JAX ring_attention's output and gradients over a sequence=n mesh."""
    import jax
    import jax.numpy as jnp

    from mpi_operator_tpu.parallel.ring_attention import ring_attention
    from mpi_operator_tpu.runtime import MeshPlan, build_mesh

    mesh = build_mesh(MeshPlan(axes={"sequence": n}), jax.devices()[:n])
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    q, k, v, do = (jnp.asarray(x, jdt) for x in (inputs or _inputs()))

    @jax.jit  # eager shard_map + scan is far slower on the CPU than one compile
    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(lambda a, b, c: ring_attention(a, b, c, mesh, causal=causal), q, k, v)
        return (o, *vjp(do))

    return [np.asarray(x, np.float32) for x in fwd_bwd(q, k, v, do)]


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_matches_jax_ring(n, tmp_path):
    run_ranks(__file__, n, {"n": n, "dir": str(tmp_path)})
    ranks = [dict(np.load(tmp_path / f"rank{i}.npz")) for i in range(n)]
    for causal, dtype in CASES:
        want = _jax_ring(n, causal, dtype)
        for name, w in zip(("o", "dq", "dk", "dv"), want):
            got = np.concatenate([r[f"{causal}-{dtype}-{name}"] for r in ranks], axis=1)
            tol = TOL[dtype][0 if name == "o" else 1]
            np.testing.assert_allclose(got, w, atol=tol, rtol=tol,
                                       err_msg=f"{name} causal={causal} {dtype} n={n}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal, dtype", CASES)
def test_fold_every_rank_matches_whole_t_kernels(n, causal, dtype):
    """The fold of every rank (K1 per block, K2/K3 per visited block with
    the merged lse) against K1–K3 over the whole T, both on the plain
    versions, heads-major."""
    dt = _torch_dtype(dtype)
    q, k, v, do = (torch.from_numpy(x).to(dt).transpose(1, 2).contiguous() for x in _inputs(1))
    scale = D ** -0.5
    o, lse, dq, dk, dv = tra.fold_every_rank(q, k, v, do, n, causal=causal, scale=scale)
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, causal, scale)
    delta = tra.attention_delta(do, o_ref)
    dq_ref = tfa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal, scale)
    dk_ref, dv_ref = tfa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal, scale)
    tol_o, tol_g = TOL[dtype]
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol_o, rtol=tol_o)
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == dt
        torch.testing.assert_close(got.float(), ref.float(), atol=tol_g, rtol=tol_g)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_plain_is_the_jax_rings_math(n, causal):
    """f32: the torch copy of the JAX ring's fold, forward and gradients."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = tra.ring_attention_plain(q, k, v, n, causal=causal)
    got = [o, *torch.autograd.grad(o, (q, k, v), do)]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got,
                          _jax_ring(n, causal, "f32", inputs=_inputs(2))):
        tol = TOL["f32"][0 if name == "o" else 1]
        np.testing.assert_allclose(g.detach().numpy(), w, atol=tol, rtol=tol, err_msg=name)


def test_ring_attention_without_a_sequence_axis_is_flash_attention():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(3))
    want = tfa.flash_attention(q, k, v, causal=True)
    assert torch.equal(tra.ring_attention(q, k, v, None, causal=True), want)
    with pytest.raises(ValueError, match="layout"):
        tra.ring_attention(q, k, v, None, layout="tbhd")


def test_block_causality_skips_only_future_blocks():
    assert [tra.block_causality(2, j, True) for j in range(4)] == [False, False, True, None]
    assert [tra.block_causality(2, j, False) for j in range(4)] == [False] * 4
    # rank i of n folds i + 1 blocks when causal: n(n+1)/2 launches of each kernel in all
    assert sum(tra.block_causality(i, j, True) is not None
               for i in range(4) for j in range(4)) == 10


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
