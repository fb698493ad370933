"""Data-parallel MNIST training worker.

Port of ``examples/mnist_worker.py`` (≙ the reference's Horovod TF MNIST:
data-parallel allreduce). Every host runs it; the trainer's FSDP2 over the
ranks gives the gradient reduction Horovod did explicitly. AdamW at lr
1e-3; each host's 32 images and labels come from ``default_rng(host_id)``,
split over its ranks. Host 0's first rank prints the first and last loss.

    python -m mpi_operator_tpu_torch.workers.mnist_worker [STEPS] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from mpi_operator_tpu_torch.models import mnist
from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
from mpi_operator_tpu_torch.ops.data import make_global_batch
from mpi_operator_tpu_torch.runtime import bootstrap
from mpi_operator_tpu_torch.runtime.topology import mesh_from_context
from mpi_operator_tpu_torch.workers import host

PER_HOST = 32


def host_batch(host_id: int, per_host: int = PER_HOST) -> dict:
    """This host's images and labels (the JAX worker's draws)."""
    rng = np.random.default_rng(host_id)
    return {"image": rng.standard_normal((per_host, 28, 28, 1)).astype(np.float32),
            "label": rng.integers(0, 10, (per_host,)).astype(np.int32)}


def main(steps: int = 30, device: Union[str, torch.device, None] = None,
         environ: Optional[Mapping[str, str]] = None, local_rank: int = 0) -> dict:
    env = os.environ if environ is None else environ
    ctx = bootstrap.context_from_env(env)
    device = bootstrap.initialize(ctx, device=device, environ=env, local_rank=local_rank)
    try:
        mesh = mesh_from_context(ctx, None, device.type) if dist.is_initialized() else None
        cfg = mnist.Config()
        trainer = Trainer(mnist.loss_fn, TrainerConfig(learning_rate=1e-3), mesh=mesh)
        state = trainer.init_state(mnist.init(cfg, torch.Generator(device=device).manual_seed(0),
                                              device))
        batch = make_global_batch(host_batch(ctx.host_id), device, mesh)
        losses = []
        for _ in range(steps):
            state, metrics = trainer.train_step(state, batch)
            losses.append(float(metrics["loss"]))
    finally:
        bootstrap.shutdown()
    record = {"first_loss": losses[0], "last_loss": losses[-1], "steps": steps,
              "hosts": ctx.num_hosts, "backend": device.type}
    if ctx.is_coordinator and local_rank == 0:
        print(f"mnist: loss {losses[0]:.4f} -> {losses[-1]:.4f} over {steps} steps "
              f"({ctx.num_hosts} hosts)", flush=True)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"training did not reduce the loss: {losses[0]} -> {losses[-1]}")
    return record


def rank_main(local_rank: int, device: Optional[str], steps: int) -> int:
    main(steps, device=device, local_rank=local_rank)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=30)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu: run on the CPU explicitly (default: cuda)")
    args = ap.parse_args()
    sys.exit(host.run_host(rank_main, args.device, (args.steps,)))
