"""Where the time of one ResNet train step goes on the card.

Runs the step ``mpi_operator_tpu_torch.bench``'s ResNet line times
(ResNet-101 at 224 px, batch 128, momentum SGD, unless BENCH_RESNET_DEPTH,
BENCH_IMAGE_SIZE and BENCH_BATCH say otherwise) on one resident batch,
under ``torch.profiler`` for a few steps after warm-up, and prints one JSON
line: device time per step by kernel class (convolutions and the head's
product; the batch norms' reductions; elementwise passes: the batch norms'
normalize and casts, ReLU, the residual adds, the SGD update; pooling;
everything else), the top kernels, the top host operations by their own
CPU time, and the device's busy and idle share of the profiled window
(``profile_llama.summarize``).

    python -m mpi_operator_tpu_torch.profile_resnet

Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mpi_operator_tpu_torch.profile_llama import card, summarize


def kernel_class(name: str) -> str:
    low = name.lower()
    if any(s in low for s in ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad", "xmma",
                              "gemm", "cutlass", "nvjet", "sm90_")):
        return "conv_and_matmul"
    if "reduce" in low:
        return "reductions"  # the batch norms' sums (and the loss's)
    if "pool" in low:
        return "pooling"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def main(steps: int = 3, warmup: int = 2) -> dict:
    from mpi_operator_tpu_torch.models import resnet
    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_imagenet

    env = os.environ
    batch_size = int(env.get("BENCH_BATCH", "128"))
    cfg = resnet.Config(depth=env.get("BENCH_RESNET_DEPTH", "resnet101"),
                        image_size=int(env.get("BENCH_IMAGE_SIZE", "224")))
    model = resnet.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    trainer = Trainer(resnet.loss_fn, TrainerConfig(learning_rate=0.1, optimizer="momentum",
                                                    grad_clip_norm=0.0))
    state = trainer.init_state(model)
    batch = make_global_batch(next(synthetic_imagenet(global_batch=batch_size,
                                                      image_size=cfg.image_size)), "cuda")
    for _ in range(warmup):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = {"model": cfg.depth, "image_size": cfg.image_size, "batch": batch_size,
           "device": card(), **summarize(prof, wall_us, steps, kernel_class)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
