"""The port's train step on meshes with ``tensor`` and ``sequence`` axes (gloo
CPU gangs) against the JAX package's ``Trainer`` on the same plan over the
virtual CPU devices, with ``loss_fn(..., mesh=mesh)`` so that the JAX side
shards heads over ``tensor`` and runs its own ring over ``sequence``.

Each rank is a fresh process (tests/test_torch_sharded_step.py's
``run_ranks``); both sides start from the JAX init tree and the same
``synthetic_tokens``, compute in f32. Held per step: loss and grad norm
within 1e-5 relative. Each parameter after the last step is held within
1e-4 in relative norm: Adam turns an f32 rounding of a gradient element
near its eps into an update difference of up to the learning rate for
that element (tests/test_torch_sharded_step.py), and the tensor-parallel
sums round in another order than XLA's (1.3e-5 seen on ``tensor=2``). Beside them,
each parameter's ``fsdp`` and ``tensor`` shard dimensions are the JAX
``NamedSharding``'s.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sharded_step import gang, jax_shard_dims, run_ranks, shard_dims  # noqa: E402

STEPS = 3
BATCH, SEQ = 4, 32
FIELDS = dict(learning_rate=1e-2, warmup_steps=1, total_steps=STEPS, weight_decay=0.1,
              grad_clip_norm=0.5)
TOL = 1e-5
TOL_PARAMS = 1e-4


def _rank(local_rank, args):
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
    from mpi_operator_tpu_torch.runtime import bootstrap

    mesh = gang(local_rank, args["plan"])
    steps = args.get("steps", STEPS)
    cfg = dataclasses.replace(llama.tiny(), compute_dtype=getattr(torch, args.get("dtype",
                                                                                  "float32")),
                              remat_layers=args["remat"])
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in np.load(args["weights"]).items()})
    trainer = Trainer(llama.loss_fn, TrainerConfig(**{**FIELDS, "total_steps": steps}),
                      mesh=mesh)
    state = trainer.init_state(model)
    placements = {n: shard_dims(p) for n, p in model.named_parameters()}
    stream = synthetic_tokens(global_batch=BATCH, seq_len=SEQ, vocab=cfg.vocab)
    losses, norms = [], []
    for _ in range(steps):
        state, m = trainer.train_step(state, make_global_batch(next(stream), "cpu", mesh))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    full = {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach().numpy()
            for n, p in model.named_parameters()}
    if dist.get_rank() == 0:
        np.savez(args["out"], **full)
        print(json.dumps({"losses": losses, "norms": norms, "placements": placements}))
    bootstrap.shutdown()


def _jax_run(plan, tree, steps=STEPS, dtype="float32"):
    import dataclasses

    import jax

    from mpi_operator_tpu.models import llama as jllama
    from mpi_operator_tpu.ops import Trainer, TrainerConfig
    from mpi_operator_tpu.ops.data import make_global_batch, synthetic_tokens
    from mpi_operator_tpu.runtime import MeshPlan, build_mesh

    jc = dataclasses.replace(jllama.tiny(), compute_dtype=getattr(jax.numpy, dtype))
    p = MeshPlan.parse(plan)
    mesh = build_mesh(p, jax.devices()[:p.total_devices])
    tr = Trainer(lambda prm, b: jllama.loss_fn(jc, prm, b, mesh=mesh), jllama.logical_axes(jc),
                 mesh, TrainerConfig(**{**FIELDS, "total_steps": steps}))
    state = tr.init_state(jax.tree.map(jax.numpy.asarray, tree))
    stream = synthetic_tokens(global_batch=BATCH, seq_len=SEQ, vocab=jc.vocab)
    losses, norms = [], []
    for _ in range(steps):
        state, m = tr.train_step(state, make_global_batch(mesh, next(stream)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, tr.params_sharding(), jax.tree.map(np.asarray, state.params)


def jax_tree_weights(tmp_path):
    """The JAX init tree of tiny() and the port's state dict of it, saved
    for the ranks: (tree, path)."""
    import jax

    from mpi_operator_tpu.models import llama as jllama
    from mpi_operator_tpu_torch.models import llama as tllama

    tree = jax.tree.map(np.asarray, jllama.init(jllama.tiny(), jax.random.PRNGKey(0)))
    weights = tmp_path / "w.npz"
    np.savez(weights, **{k: v.numpy() for k, v in tllama.params_from_jax(tree).items()})
    return tree, weights


def check_step_against_jax(plan, tmp_path, script=__file__, steps=STEPS):
    """Run the plan's gang (``script``'s ``_rank``) and the JAX trainer, and
    hold them together. A plan of three axes runs the per-layer remat (the
    JAX side's tiny() does not: it changes no value), so the ring sits
    between the checkpointed regions under FSDP2's hooks."""
    from mpi_operator_tpu_torch.models import llama as tllama

    tree, weights = jax_tree_weights(tmp_path)
    sizes = {a.split("=")[0]: int(a.split("=")[1]) for a in plan.split(",")}
    got = run_ranks(script, int(np.prod(list(sizes.values()))),
                    {"plan": plan, "weights": str(weights), "out": str(tmp_path / "out.npz"),
                     "remat": len(sizes) == 3, "steps": steps})
    losses, norms, shardings, params = _jax_run(plan, tree, steps)

    np.testing.assert_allclose(got["losses"], losses, rtol=TOL)
    np.testing.assert_allclose(got["norms"], norms, rtol=TOL)
    want = jax_shard_dims(shardings, sizes)
    for name, dims in got["placements"].items():
        assert dims == want[name.split(".")[-1]], name
    if "tensor" in sizes:
        assert got["placements"]["layers.0.wq"]["tensor"] == 1
        assert got["placements"]["layers.0.w_down"]["tensor"] == 0
        assert got["placements"]["embed"]["tensor"] == 0
    full = dict(np.load(tmp_path / "out.npz"))
    for name, w in tllama.params_from_jax(params).items():
        w = w.numpy()
        assert np.linalg.norm(full[name] - w) <= TOL_PARAMS * np.linalg.norm(w), name


@pytest.mark.parametrize("plan", ["tensor=2", "fsdp=2,tensor=2"])
def test_tensor_step_matches_jax_trainer(plan, tmp_path):
    """``tensor`` alone and with FSDP2 (2-D); the ``sequence`` plans are in
    tests/test_torch_sequence_parallel.py, so that the two files run side
    by side under ``--dist loadfile``."""
    check_step_against_jax(plan, tmp_path)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
