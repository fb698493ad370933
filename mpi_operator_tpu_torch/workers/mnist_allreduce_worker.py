"""Explicit-allreduce MNIST worker: the Horovod idiom on the collective verbs.

Port of ``examples/mnist_allreduce_worker.py`` (≙ the reference's
Horovod-MXNet MNIST). Where workers/mnist_worker.py lets the trainer
reduce the gradients, this worker drives the verbs of
parallel/collectives.py itself, as Horovod hooks MXNet:

- the weights start divergent per host (``torch.Generator`` seeded with the
  host id), then host 0's are broadcast to every rank
  (≙ ``hvd.broadcast_parameters``);
- each step computes the gradients of this rank's shard of the batch and
  mean-allreduces them (≙ ``hvd.DistributedOptimizer``);
- the update is plain SGD on the replicated weights: no trainer.

A two-layer MLP, 784 → 128 → 10. Env: MNIST_AR_STEPS (30), MNIST_AR_BATCH
per host (32), MNIST_AR_LR (0.5). Host 0's first rank prints one JSON line.

    python -m mpi_operator_tpu_torch.workers.mnist_allreduce_worker [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mpi_operator_tpu_torch.ops.data import make_global_batch
from mpi_operator_tpu_torch.parallel import collectives
from mpi_operator_tpu_torch.runtime import bootstrap
from mpi_operator_tpu_torch.runtime.topology import mesh_from_context
from mpi_operator_tpu_torch.workers import host


def init_params(generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Two-layer MLP, 784 → 128 → 10, from ``generator``."""
    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=device)

    return {"w1": normal(784, 128) * 784 ** -0.5, "b1": torch.zeros(128, device=device),
            "w2": normal(128, 10) * 128 ** -0.5, "b2": torch.zeros(10, device=device)}


def local_loss(params, batch):
    """Cross-entropy on this rank's shard; no collective in here."""
    x = batch["image"].reshape(batch["image"].shape[0], -1)
    h = F.relu(x @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    return -torch.log_softmax(logits, -1).gather(1, batch["label"][:, None]).mean()


def main(device: Union[str, torch.device, None] = None,
         environ: Optional[Mapping[str, str]] = None, local_rank: int = 0) -> dict:
    env = os.environ if environ is None else environ
    ctx = bootstrap.context_from_env(env)
    device = bootstrap.initialize(ctx, device=device, environ=env, local_rank=local_rank)
    try:
        return _train(env, ctx, device, local_rank)
    finally:
        bootstrap.shutdown()


def _train(env, ctx, device, local_rank) -> dict:
    steps = int(env.get("MNIST_AR_STEPS", "30"))
    per_host = int(env.get("MNIST_AR_BATCH", "32"))
    lr = float(env.get("MNIST_AR_LR", "0.5"))
    gang = dist.is_initialized()
    mesh = mesh_from_context(ctx, None, device.type) if gang else None
    group = dist.group.WORLD if gang else None

    # ≙ hvd.broadcast_parameters: divergent per host on purpose; host 0's win
    params = init_params(torch.Generator(device=device).manual_seed(ctx.host_id), device)
    if group is not None:
        params = {k: collectives.broadcast_root(v, group) for k, v in params.items()}
    for p in params.values():
        p.requires_grad_()

    rng = np.random.default_rng(ctx.host_id)
    batch = make_global_batch(
        {"image": rng.standard_normal((per_host, 28, 28, 1)).astype(np.float32),
         "label": rng.integers(0, 10, (per_host,)).astype(np.int32)}, device, mesh)
    losses = []
    for _ in range(steps):
        loss = local_loss(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            if group is not None:  # ≙ hvd.DistributedOptimizer's averaged allreduce
                grads = [collectives.pmean(g, group) for g in grads]
                loss = collectives.pmean(loss, group)
            for p, g in zip(params.values(), grads):
                p.sub_(lr * g)
        losses.append(float(loss.detach()))
    record = {"workload": "mnist_allreduce", "first_loss": losses[0], "last_loss": losses[-1],
              "steps": steps, "hosts": ctx.num_hosts, "backend": device.type}
    if ctx.is_coordinator and local_rank == 0:
        print(json.dumps(record), flush=True)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"training did not reduce the loss: {losses[0]} -> {losses[-1]}")
    return record


def rank_main(local_rank: int, device: Optional[str]) -> int:
    main(device=device, local_rank=local_rank)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu: run on the CPU explicitly (default: cuda)")
    sys.exit(host.run_host(rank_main, ap.parse_args().device))
