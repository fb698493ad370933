"""The port's MoE layer (``parallel/moe.py``) against the JAX package's
(``mpi_operator_tpu/parallel/moe.py``), from the same parameters (the JAX
init tree) and the same x (numpy, seeded).

- Local path: y and the aux loss within 1e-5 (f32 compute; relative to
  max|y| for y) and within 3e-2·max|y| in bf16; gradients of
  ``mean(y²) + 0.01·aux`` w.r.t. x, the router and both expert weights
  within 1e-5 of ``jax.grad``'s (f32), relative to each gradient's max.
- Sharded: ``expert=2`` and ``expert=4`` on gloo ranks (each runs its
  experts' buffers, the buffers gathered over the axis) against JAX's
  ``shard_map`` path on its CPU mesh of as many devices: y, aux and the
  gradients (whole on every rank) within the same 1e-5.
- Capacity: capacity 1 per expert drops most tokens to zero rows, as
  ``tests/test_pipeline_moe.py::test_moe_capacity_drops_tokens`` pins for
  the JAX layer, and the same rows as JAX's.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sharded_step import gang, run_ranks  # noqa: E402

TOL = 1e-5
D_MODEL, D_FF, N_EXPERTS, CF = 32, 64, 4, 1.25


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, (
        float(np.abs(got - want).max()), scale)


def _port_forward_backward(cfg, params, x, mesh=None):
    """(y, aux, grads) of the port's layer; grads of mean(y²) + 0.01·aux
    w.r.t. x and each leaf, as numpy."""
    import torch

    from mpi_operator_tpu_torch.parallel import moe as tmoe

    leaves = {f"{g}.{k}": v.clone().requires_grad_() for g, sub in params.items()
              for k, v in sub.items()}
    tree = {g: {k: leaves[f"{g}.{k}"] for k in sub} for g, sub in params.items()}
    xt = x.clone().requires_grad_()
    y, aux = tmoe.apply(cfg, tree, xt, mesh=mesh)
    loss = (y.float() ** 2).mean() + 0.01 * aux
    grads = torch.autograd.grad(loss, [xt, *leaves.values()])
    names = ["x", *leaves]
    return (y.detach().float().numpy(), float(aux.detach()),
            {n: g.float().numpy() for n, g in zip(names, grads)})


def _rank(local_rank, args):
    import torch

    from mpi_operator_tpu_torch.parallel import moe as tmoe
    from mpi_operator_tpu_torch.runtime import bootstrap

    mesh = gang(local_rank, args["plan"])
    data = dict(np.load(args["inputs"]))
    cfg = tmoe.MoEConfig(d_model=D_MODEL, d_ff=D_FF, n_experts=N_EXPERTS,
                         capacity_factor=CF, compute_dtype=torch.float32)
    params = {g: {"w": torch.from_numpy(data[g])} for g in ("router", "w_in", "w_out")}
    y, aux, grads = _port_forward_backward(cfg, params, torch.from_numpy(data["x"]), mesh)
    np.savez(args["out"] + f".{local_rank}.npz", y=y, aux=aux, **grads)
    print(json.dumps({"rank": local_rank}))
    bootstrap.shutdown()


def _jax_side(plan_n=None, dtype="float32", cf=CF, shape=(2, 16, D_MODEL)):
    """(cfg, params tree, x, y, aux, grads) of the JAX layer, sharded over
    ``plan_n`` expert devices when given."""
    import jax
    import jax.numpy as jnp

    from mpi_operator_tpu.parallel import moe as jmoe
    from mpi_operator_tpu.runtime import MeshPlan, build_mesh

    cfg = jmoe.MoEConfig(d_model=shape[-1], d_ff=D_FF, n_experts=N_EXPERTS, capacity_factor=cf,
                         compute_dtype=getattr(jnp, dtype))
    params = jmoe.init(cfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    mesh = None
    if plan_n:
        mesh = build_mesh(MeshPlan(axes={"expert": plan_n}), jax.devices()[:plan_n])

    def loss(p, xx):
        y, aux = jmoe.apply(cfg, p, xx, mesh=mesh)
        return jnp.mean(y.astype(jnp.float32) ** 2) + 0.01 * aux

    y, aux = jax.jit(lambda p, xx: jmoe.apply(cfg, p, xx, mesh=mesh))(params, x)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    grads = {"x": np.asarray(gx), **{f"{g}.w": np.asarray(gp[g]["w"]) for g in gp}}
    params = jax.tree.map(np.asarray, params)
    return params, x, np.asarray(y, np.float32), float(aux), grads


def _torch_cfg(dtype, cf=CF, d_model=D_MODEL):
    import torch

    from mpi_operator_tpu_torch.parallel import moe as tmoe

    return tmoe.MoEConfig(d_model=d_model, d_ff=D_FF, n_experts=N_EXPERTS, capacity_factor=cf,
                          compute_dtype=getattr(torch, dtype))


def test_local_path_matches_jax_f32_with_gradients():
    import torch

    from mpi_operator_tpu_torch.parallel import moe as tmoe

    params, x, y_ref, aux_ref, g_ref = _jax_side()
    y, aux, grads = _port_forward_backward(_torch_cfg("float32"), tmoe.params_from_jax(params),
                                           torch.from_numpy(x))
    _close(y, y_ref, TOL)
    assert abs(aux - aux_ref) <= TOL * abs(aux_ref)
    assert set(grads) == set(g_ref) == {"x", "router.w", "w_in.w", "w_out.w"}
    for name in grads:
        _close(grads[name], g_ref[name], TOL)
    assert np.abs(grads["router.w"]).sum() > 0  # the gate carries the router's gradient
    assert tmoe.logical_axes(_torch_cfg("float32")) == {
        "router": {"w": ("embed", None)}, "w_in": {"w": ("expert", "embed", "mlp")},
        "w_out": {"w": ("expert", "mlp", "embed")}}


def test_local_path_matches_jax_bf16():
    import torch

    from mpi_operator_tpu_torch.parallel import moe as tmoe

    params, x, y_ref, aux_ref, _ = _jax_side(dtype="bfloat16")
    y, aux = tmoe.apply(_torch_cfg("bfloat16"), tmoe.params_from_jax(params), torch.from_numpy(x))
    _close(y.float().numpy(), y_ref, 3e-2)
    assert abs(float(aux) - aux_ref) <= TOL * abs(aux_ref)  # routing is f32 on both sides


@pytest.mark.parametrize("n", [2, 4])
def test_expert_sharded_matches_jax_shard_map(n, tmp_path):
    params, x, y_ref, aux_ref, g_ref = _jax_side(plan_n=n)
    np.savez(tmp_path / "in.npz", x=x, **{g: params[g]["w"] for g in params})
    run_ranks(__file__, n, {"plan": f"expert={n}", "inputs": str(tmp_path / "in.npz"),
                            "out": str(tmp_path / "out")})
    for r in range(n):
        got = dict(np.load(tmp_path / f"out.{r}.npz"))
        _close(got["y"], y_ref, TOL)
        assert abs(float(got["aux"]) - aux_ref) <= TOL * abs(aux_ref)
        for name, want in g_ref.items():
            _close(got[name], want, TOL)


def test_capacity_drops_tokens_as_jax_does():
    import torch

    from mpi_operator_tpu_torch.parallel import moe as tmoe

    params, x, y_ref, _, _ = _jax_side(cf=0.1, shape=(1, 32, 8))
    y, _ = tmoe.apply(_torch_cfg("float32", cf=0.1, d_model=8), tmoe.params_from_jax(params),
                      torch.from_numpy(x))
    zero = np.all(y[0].numpy() == 0, axis=-1)
    # capacity max(int(0.1 * 32 / 4), 1) = 1 per expert: at most 4 tokens kept
    assert zero.sum() >= 28
    assert np.array_equal(zero, np.all(y_ref[0] == 0, axis=-1))
    _close(y.numpy(), y_ref, TOL)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
