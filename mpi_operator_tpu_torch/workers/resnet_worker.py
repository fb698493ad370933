"""ResNet training worker: the headline benchmark through the operator path.

Port of ``examples/resnet_worker.py`` (≙ the reference's tf_cnn_benchmarks
job: ResNet-101, synthetic ImageNet, data parallelism). Every host runs
it; the ``TPUJOB_*`` env gives the rendezvous, and the trainer's FSDP2 over
the ranks (pure data parallelism, global batch norm) gives the gradient
reduction Horovod gave there. Config via the same env:

  RESNET_DEPTH    resnet26 | resnet50 | resnet101  (default resnet101)
  RESNET_BATCH    per-chip batch   (default 128)
  RESNET_STEPS    timed steps      (default 30, after one untimed step)
  RESNET_IMAGE    edge pixels      (default 224)
  RESNET_CLASSES  classes          (default 1000)

Host 0's first rank prints one JSON line. One rank per local chip
(workers/host.py).

    python -m mpi_operator_tpu_torch.workers.resnet_worker [--device cpu]

Runs on CUDA; ``--device cpu`` (``main(device="cpu")``) is the explicit CPU
run the operator's CPU tests use.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Mapping, Optional, Union

import torch
import torch.distributed as dist

from mpi_operator_tpu_torch.models import resnet
from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_imagenet
from mpi_operator_tpu_torch.runtime import bootstrap
from mpi_operator_tpu_torch.runtime.topology import mesh_from_context
from mpi_operator_tpu_torch.workers import host


def main(device: Union[str, torch.device, None] = None,
         environ: Optional[Mapping[str, str]] = None, local_rank: int = 0) -> dict:
    """Train and return the JSON record (printed by host 0's first rank)."""
    env = os.environ if environ is None else environ
    ctx = bootstrap.context_from_env(env)
    device = bootstrap.initialize(ctx, device=device, environ=env, local_rank=local_rank)
    try:
        return _train(env, ctx, device, local_rank)
    finally:
        bootstrap.shutdown()


def _train(env, ctx, device, local_rank) -> dict:
    gang = dist.is_initialized()
    mesh = mesh_from_context(ctx, None, device.type) if gang else None
    world = dist.get_world_size() if gang else 1
    depth = env.get("RESNET_DEPTH", "resnet101")
    per_chip = int(env.get("RESNET_BATCH", "128"))
    steps = int(env.get("RESNET_STEPS", "30"))
    image = int(env.get("RESNET_IMAGE", "224"))
    classes = int(env.get("RESNET_CLASSES", "1000"))

    cfg = resnet.Config(depth=depth, image_size=image, num_classes=classes)
    model = resnet.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    trainer = Trainer(resnet.loss_fn, TrainerConfig(learning_rate=0.1, optimizer="momentum",
                                                    grad_clip_norm=0.0), mesh=mesh)
    state = trainer.init_state(model)
    global_batch = per_chip * world
    stream = synthetic_imagenet(global_batch=global_batch, image_size=image, num_classes=classes)
    batch = make_global_batch(next(stream), device, mesh)

    state, metrics = trainer.train_step(state, batch)  # warm-up: cuDNN's algorithm search
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
    loss = float(metrics["loss"])  # waits for the device
    dt = time.perf_counter() - t0
    img_s = global_batch * steps / dt
    record = {
        "model": depth,
        "images_per_sec": img_s,
        "images_per_sec_per_chip": img_s / world,
        "hosts": ctx.num_hosts,
        "chips": world,
        "global_batch": global_batch,
        "loss": loss,
        "backend": device.type,
    }
    if ctx.is_coordinator and local_rank == 0:
        print(json.dumps(record), flush=True)
    return record


def rank_main(local_rank: int, device: Optional[str]) -> int:
    main(device=device, local_rank=local_rank)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu: run on the CPU explicitly (default: cuda)")
    sys.exit(host.run_host(rank_main, ap.parse_args().device))
