"""Llama decoder training worker on one CUDA device.

Port of ``examples/llama_worker.py``'s plain (non-elastic) loop. Config via
the same env, so one manifest runs either worker:

  LLAMA_CONFIG  tiny | bench | 8b   (default tiny)
  LLAMA_BATCH   per-device batch    (default 2)
  LLAMA_SEQ     sequence length     (default 64)
  LLAMA_STEPS   train steps         (default 6)
  LLAMA_PROGRESS_EVERY  print "progress: batch N" every N batches (default off)

Elastic training with checkpoints (``LLAMA_CKPT``, or a shared checkpoint
volume advertised as ``TPUJOB_CKPT_DIR``) and the FSDP/TP mesh
(``LLAMA_MESH``, ``LLAMA_MESH_DCN``) are not ported yet and raise.

    python -m mpi_operator_tpu_torch.workers.llama_worker

Runs on CUDA; ``main(device="cpu")`` is the explicit CPU run the tests use.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping, Optional, Union

import torch

from mpi_operator_tpu_torch.models import llama
from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
from mpi_operator_tpu_torch.runtime import bootstrap

CONFIGS = {
    "tiny": llama.tiny,
    "bench": llama.bench_single_chip,
    "8b": llama.llama3_8b,
}


def main(
    device: Union[str, torch.device, None] = None,
    environ: Optional[Mapping[str, str]] = None,
) -> dict:
    env = os.environ if environ is None else environ
    for name in ("LLAMA_MESH", "LLAMA_MESH_DCN", "LLAMA_CKPT"):
        if env.get(name, "").strip():
            raise NotImplementedError(
                f"{name} is not yet ported to the PyTorch worker (mesh, elastic "
                "training and checkpoints are later slices)"
            )
    ctx = bootstrap.context_from_env(env)
    if bootstrap.default_checkpoint_dir(ctx, env):
        raise NotImplementedError(
            f"{bootstrap.ENV_CKPT_DIR} is set: checkpointed elastic training is not "
            "yet ported to the PyTorch worker"
        )
    device = bootstrap.initialize(ctx, device=device)

    cfg = CONFIGS[env.get("LLAMA_CONFIG", "tiny")]()
    batch_size = int(env.get("LLAMA_BATCH", "2"))
    seq_len = int(env.get("LLAMA_SEQ", "64"))
    steps = int(env.get("LLAMA_STEPS", "6"))
    progress_every = int(env.get("LLAMA_PROGRESS_EVERY", "0") or 0)

    model = llama.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    trainer = Trainer(
        llama.loss_fn,
        TrainerConfig(learning_rate=3e-4, optimizer="adamw", grad_clip_norm=1.0),
    )
    state = trainer.init_state(model)
    tokens = synthetic_tokens(global_batch=batch_size, seq_len=seq_len, vocab=cfg.vocab)

    t0 = time.perf_counter()
    for i in range(steps):
        if progress_every and i and i % progress_every == 0 and ctx.is_coordinator:
            print(f"progress: batch {i}", flush=True)
        state, metrics = trainer.train_step(state, make_global_batch(next(tokens), device))
    loss = float(metrics["loss"])  # waits for the device
    dt = time.perf_counter() - t0

    record = {
        "workload": "llama",
        "outcome": "done",
        "step": steps,
        "start_step": 0,
        "loss": loss,
        "tokens_per_sec": round(batch_size * steps * seq_len / dt, 1),
        "hosts": ctx.num_hosts,
        "backend": device.type,
        "mesh": "",
    }
    if ctx.is_coordinator:
        print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
