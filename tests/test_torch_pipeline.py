"""The port's GPipe schedule (``parallel/pipeline.py``) against the JAX
package's (``mpi_operator_tpu/parallel/pipeline.py``), from the same
stacked parameters (the JAX test's ``tanh(x @ w + b)`` layers) and x.

- ``data=2,pipe=4`` on 8 gloo ranks, M ∈ {4, 8} microbatches: the whole
  output on every rank within 1e-5 of JAX's ``run_pipeline`` on its CPU
  mesh (f32), and the gradients of ``sum(y)`` w.r.t. the stacked params,
  summed over the ranks (each holds its stage's layers from its rows),
  within 1e-5 of ``jax.grad`` of the JAX ``run_pipeline``.
- Without a ``pipe`` axis (no mesh, or a ``data`` mesh) the layers run in
  order, as JAX's fall-back does.
- ``ring_shift``'s backward moves the gradient the other way round.
"""

import json
import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sharded_step import gang, run_ranks  # noqa: E402

TOL = 1e-5
N_LAYERS, D, B = 8, 16, 16
MICRO = (4, 8)


def _stage_torch(p, x):
    import torch

    return torch.tanh(x @ p["w"] + p["b"])


def _inputs():
    import jax

    ks = jax.random.split(jax.random.PRNGKey(0), N_LAYERS)
    w = np.stack([np.asarray(jax.random.normal(k, (D, D))) * 0.5 for k in ks])
    b = np.random.default_rng(2).standard_normal((N_LAYERS, D)).astype(np.float32) * 0.1
    x = np.random.default_rng(1).standard_normal((B, D)).astype(np.float32)
    return {"w": w.astype(np.float32), "b": b}, x


def _jax_run(params, x, n_micro, plan):
    import jax
    import jax.numpy as jnp

    from mpi_operator_tpu.parallel.pipeline import run_pipeline
    from mpi_operator_tpu.runtime import MeshPlan, build_mesh

    p = MeshPlan.parse(plan)
    mesh = build_mesh(p, jax.devices()[:p.total_devices])

    def stage(prm, h):
        return jnp.tanh(h @ prm["w"] + prm["b"])

    def fwd(prm, xx):
        return run_pipeline(stage, prm, xx, mesh, n_microbatches=n_micro)

    y = jax.jit(fwd)(params, x)
    g = jax.grad(lambda prm: jnp.sum(fwd(prm, x)))(params)
    return np.asarray(y), {k: np.asarray(v) for k, v in g.items()}


def _rank(local_rank, args):
    import torch
    import torch.distributed as dist

    from mpi_operator_tpu_torch.parallel.pipeline import run_pipeline
    from mpi_operator_tpu_torch.runtime import bootstrap

    mesh = gang(local_rank, args["plan"])
    data = dict(np.load(args["inputs"]))
    out = {}
    for m in args["micro"]:
        params = {k: torch.from_numpy(data[k]).requires_grad_() for k in ("w", "b")}
        y = run_pipeline(_stage_torch, params, torch.from_numpy(data["x"]), mesh,
                         n_microbatches=m)
        y.sum().backward()
        grads = {k: v.grad.clone() for k, v in params.items()}
        for g in grads.values():
            dist.all_reduce(g)
        out[f"y{m}"] = y.detach().numpy()
        out.update({f"g{m}_{k}": g.numpy() for k, g in grads.items()})
    ys = [torch.from_numpy(out[f"y{m}"]) for m in args["micro"]]
    gathered = [[torch.empty_like(y) for _ in range(dist.get_world_size())] for y in ys]
    for y, parts in zip(ys, gathered):
        dist.all_gather(parts, y)
    # every rank returns the whole output
    same = all(torch.equal(p, parts[0]) for parts in gathered for p in parts)
    if dist.get_rank() == 0:
        np.savez(args["out"], **out)
    print(json.dumps({"same_on_every_rank": same}))
    bootstrap.shutdown()


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOL * scale


@pytest.fixture(scope="module")
def pipeline_gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    params, x = _inputs()
    np.savez(tmp / "in.npz", x=x, **params)
    rec = run_ranks(__file__, 8, {"plan": "data=2,pipe=4", "inputs": str(tmp / "in.npz"),
                                  "out": str(tmp / "out.npz"), "micro": list(MICRO)})
    return params, x, rec, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("n_micro", MICRO)
def test_pipeline_matches_jax_forward_and_gradients(n_micro, pipeline_gang):
    params, x, rec, got = pipeline_gang
    assert rec["same_on_every_rank"]
    y, grads = _jax_run(params, x, n_micro, "data=2,pipe=4")
    _close(got[f"y{n_micro}"], y)
    for k in ("w", "b"):
        _close(got[f"g{n_micro}_{k}"], grads[k])


def test_pipeline_without_a_pipe_axis_runs_the_layers_in_order():
    import torch

    from mpi_operator_tpu_torch.parallel.pipeline import run_pipeline

    params, x = _inputs()
    y_jax, _ = _jax_run(params, x, 2, "data=8")
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    data_mesh = types.SimpleNamespace(mesh_dim_names=("data", "fsdp"), mesh=np.zeros((8, 1)))
    for mesh in (None, data_mesh):
        y = run_pipeline(_stage_torch, tp, torch.from_numpy(x), mesh, n_microbatches=2)
        _close(y.numpy(), y_jax)


def _shift_rank(local_rank, args):
    import torch

    from mpi_operator_tpu_torch.parallel import collectives as c
    from mpi_operator_tpu_torch.runtime import bootstrap

    mesh = gang(local_rank, args["plan"])
    group = mesh.get_group("pipe")
    i = c.axis_index(group)
    x = torch.full((3,), float(i + 1), requires_grad=True)
    y = c.ring_shift(x, group)  # index i now holds index i - 1's
    (y * float(10 * (i + 1))).sum().backward()
    print(json.dumps({"y": y.tolist(), "grad": x.grad.tolist(), "i": i}))
    bootstrap.shutdown()


def test_ring_shift_gradient_moves_the_other_way(tmp_path):
    rec = run_ranks(__file__, 3, {"plan": "pipe=3", "fn": "shift"})
    # rank 0 holds rank 2's x; rank 0's x went to rank 1, whose loss weight is 20
    assert rec == {"y": [3.0] * 3, "grad": [20.0] * 3, "i": 0}


if __name__ == "__main__":
    a = json.loads(sys.argv[2])
    (_shift_rank if a.get("fn") == "shift" else _rank)(int(sys.argv[1]), a)
