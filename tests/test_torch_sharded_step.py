"""The port's sharded train step (FSDP2 over a gloo CPU gang) against the
JAX package's ``Trainer`` on the same plan over the virtual CPU devices.

Each rank is a fresh ``python`` process running this file (never a fork of
the test process, which has JAX loaded): one host with N chips, rendezvous
at a free localhost port. The JAX side runs in the test process. Both start
from the JAX init tree (``params_from_jax``) and the same
``synthetic_tokens``; compute is f32 on both sides.

Tolerances are the single-device trainer test's (tests/test_torch_trainer.py):
loss and grad_norm 1e-5 relative per step; with a bf16 first moment 1e-4.
Each parameter after the last step is held to the same bound as a whole
(the norm of its difference over its norm): the gradient average over the
ranks sums in another order, and Adam turns an f32 rounding of a gradient
near its eps into an update difference of up to the learning rate for that
one element (2 of 4096 elements of one matrix read 2e-5 absolute). With a
bf16 first moment only the losses and norms are held: flipped bf16
roundings put the parameters 1.3e-4 (relative norm) from the JAX package's
after 5 steps on one device already. Beside them, each parameter's shard
dimensions must be the ones the JAX ``NamedSharding`` shards over ``fsdp``
and ``tensor`` (:func:`shard_dims`, :func:`jax_shard_dims`; the ``tensor``
plans are tests/test_torch_tensor_parallel.py's, with the same helpers).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
BATCH, SEQ = 4, 32


def free_port() -> int:
    """A port that binds now, from below the kernel's ephemeral range: the
    gangs' own connections take ephemeral ports, and one of them could take
    a port chosen there before rank 0 binds it."""
    import random

    while True:
        port = random.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


def _run_once(script, n, args, timeout):
    """One launch of the ranks: [(exit code, stdout, stderr)] per rank. Output
    goes to files (a full pipe would stall a rank in a collective); once a
    rank fails, the rest get 10 s to finish before they are killed."""
    import tempfile
    import time

    # one thread per rank: the ranks share the test machine's cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", TPUJOB_NUM_HOSTS="1",
               TPUJOB_CHIPS_PER_HOST=str(n),
               TPUJOB_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}")
    with tempfile.TemporaryDirectory() as tmp:
        files = [(open(os.path.join(tmp, f"{r}.out"), "w+"), open(os.path.join(tmp, f"{r}.err"), "w+"))
                 for r in range(n)]
        procs = [subprocess.Popen([sys.executable, script, str(r), json.dumps(args)], cwd=REPO,
                                  env=env, stdout=o, stderr=e, text=True)
                 for r, (o, e) in enumerate(files)]
        deadline, failed_at = time.monotonic() + timeout, None
        try:
            while any(p.poll() is None for p in procs):
                now = time.monotonic()
                if failed_at is None and any(p.poll() not in (None, 0) for p in procs):
                    failed_at = now
                if now > deadline or (failed_at is not None and now - failed_at > 10):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=30)
        results = []
        for p, (o, e) in zip(procs, files):
            o.seek(0)
            e.seek(0)
            results.append((p.returncode, o.read(), e.read()))
            o.close()
            e.close()
        return results


def run_ranks(script, n, args, *, timeout=240):
    """Run ``script`` as ranks 0..n-1 of one host with n chips (fresh
    processes, gloo over a free localhost port). Returns rank 0's last
    stdout line parsed as JSON; fails on any rank's non-zero exit. A gang
    whose rendezvous port was taken between choosing and binding it
    (another test's process got there first) is launched once more on a
    new port."""
    results = _run_once(script, n, args, timeout)
    if any(rc != 0 and "EADDRINUSE" in err for rc, _, err in results):
        results = _run_once(script, n, args, timeout)
    for r, (rc, _, err) in enumerate(results):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    return json.loads(results[0][1].strip().splitlines()[-1])


def gang(local_rank, plan):
    """Join the gang as ``local_rank`` (CPU, gloo) and build the plan's mesh."""
    from mpi_operator_tpu_torch.runtime import bootstrap
    from mpi_operator_tpu_torch.runtime.topology import MeshPlan, mesh_from_context

    ctx = bootstrap.context_from_env()
    bootstrap.initialize(ctx, device="cpu", local_rank=local_rank, group=True)
    return mesh_from_context(ctx, MeshPlan.parse(plan), "cpu")


def shard_dims(p):
    """mesh axis → the dimension it shards, of a sharded parameter (axes above
    size 1 only; FSDP2's and the tensor split's DTensors name their axes)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return {}
    mesh = p.device_mesh
    return {name: pl.dim for name, pl, size in zip(mesh.mesh_dim_names, p.placements, mesh.shape)
            if pl.is_shard() and size > 1}


def jax_shard_dims(shardings, sizes):
    """Port parameter name → {mesh axis: dim} of the JAX sharding (axes above
    size 1; the layer stack's leading axis dropped)."""
    from mpi_operator_tpu_torch.models.llama import _LAYER_LEAVES, _TOP_LEAVES

    def dims(spec, stacked):
        out = {}
        for d, part in enumerate(spec):
            for axis in (part,) if isinstance(part, str) else (part or ()):
                if sizes.get(axis, 1) > 1:
                    out[axis] = d - stacked
        return out

    out = {name: dims(shardings[g][leaf].spec, 0) for (g, leaf), name in _TOP_LEAVES.items()}
    for (g, leaf), name in _LAYER_LEAVES.items():
        out[name] = dims(shardings["layers"][g][leaf].spec, 1)
    return out


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
    cfg = dataclasses.replace(llama.tiny(), compute_dtype=torch.float32,
                              remat_layers=args["remat"])
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in np.load(args["weights"]).items()})
    trainer = Trainer(llama.loss_fn, TrainerConfig(**args["fields"]), mesh=mesh)
    state = trainer.init_state(model)

    placements = {n: shard_dims(p) for n, p in model.named_parameters()}
    stream = synthetic_tokens(global_batch=BATCH, seq_len=SEQ, vocab=cfg.vocab)
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, make_global_batch(next(stream), "cpu", mesh))
        losses.append(m["loss"].item())
        if "grad_norm" in m:
            norms.append(m["grad_norm"].item())
    full = {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach().numpy()
            for n, p in model.named_parameters()}
    if dist.get_rank() == 0:
        np.savez(args["out"], **full)
        print(json.dumps({"losses": losses, "norms": norms, "placements": placements}))
    bootstrap.shutdown()


def _jax_run(plan, fields, tree):
    """The JAX trainer on the same plan over the virtual CPU devices."""
    import dataclasses

    import jax

    from mpi_operator_tpu.models import llama as jllama
    from mpi_operator_tpu.ops import Trainer, TrainerConfig
    from mpi_operator_tpu.ops.data import make_global_batch, synthetic_tokens
    from mpi_operator_tpu.runtime import MeshPlan, build_mesh

    jc = dataclasses.replace(jllama.tiny(), compute_dtype=jax.numpy.float32)
    p = MeshPlan.parse(plan)
    mesh = build_mesh(p, jax.devices()[:p.total_devices])
    tr = Trainer(lambda prm, b: jllama.loss_fn(jc, prm, b), jllama.logical_axes(jc), mesh,
                 TrainerConfig(**fields))
    state = tr.init_state(jax.tree.map(jax.numpy.asarray, tree))
    stream = synthetic_tokens(global_batch=BATCH, seq_len=SEQ, vocab=jc.vocab)
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = tr.train_step(state, make_global_batch(mesh, next(stream)))
        losses.append(float(m["loss"]))
        if "grad_norm" in m:
            norms.append(float(m["grad_norm"]))
    return losses, norms, tr.params_sharding(), jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize(
    "plan, fields, tol",
    [
        ("fsdp=2", dict(learning_rate=1e-2, warmup_steps=2, total_steps=STEPS,
                        weight_decay=0.1, grad_clip_norm=0.5), 1e-5),
        ("data=2,fsdp=2", dict(learning_rate=3e-3, adam_mu_bf16=True, grad_clip_norm=1.0),
         1e-4),
    ],
)
def test_sharded_step_matches_jax_trainer(plan, fields, tol, tmp_path):
    """The fsdp=2 case runs the per-layer remat (JAX's tiny() does not: the
    remat changes no value), so FSDP2's hooks meet the recomputed regions."""
    import jax

    from mpi_operator_tpu.models import llama as jllama
    from mpi_operator_tpu_torch.models import llama as tllama

    tree = jax.tree.map(np.asarray, jllama.init(jllama.tiny(), jax.random.PRNGKey(0)))
    weights = tmp_path / "w.npz"
    np.savez(weights, **{k: v.numpy() for k, v in tllama.params_from_jax(tree).items()})
    n = int(np.prod([int(a.split("=")[1]) for a in plan.split(",")]))
    got = run_ranks(__file__, n, {"plan": plan, "fields": fields, "weights": str(weights),
                                  "out": str(tmp_path / "out.npz"),
                                  "remat": plan == "fsdp=2"})
    losses, norms, shardings, params = _jax_run(plan, fields, tree)

    np.testing.assert_allclose(got["losses"], losses, rtol=tol)
    np.testing.assert_allclose(got["norms"], norms, rtol=tol)
    assert len(norms) == STEPS
    sizes = {a.split("=")[0]: int(a.split("=")[1]) for a in plan.split(",")}
    want_dims = jax_shard_dims(shardings, sizes)
    for name, d in got["placements"].items():
        assert d == want_dims[name.split(".")[-1]], name
    assert got["placements"]["layers.0.wq"] == {"fsdp": 0}
    assert got["placements"]["layers.0.wo"] == {"fsdp": 1}
    if fields.get("adam_mu_bf16"):
        return
    full = dict(np.load(tmp_path / "out.npz"))
    for name, w in tllama.params_from_jax(params).items():
        w = w.numpy()
        assert np.linalg.norm(full[name] - w) <= tol * np.linalg.norm(w), name


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
