"""Llama decoder training worker: one rank per CUDA device, sharded over the
job's mesh (tensor parallelism, ring attention, FSDP2), elastic through
checkpoints.

Port of ``examples/llama_worker.py``. Config via the same env, so one
manifest runs either worker:

  LLAMA_CONFIG  tiny | bench | 8b   (default tiny)
  LLAMA_BATCH   per-chip batch      (default 2)
  LLAMA_SEQ     sequence length     (default 64)
  LLAMA_STEPS   total train steps   (default 6)
  LLAMA_CKPT    checkpoint dir      (default: the job's directory on the
                shared volume a node agent advertises as TPUJOB_CKPT_DIR;
                neither: no elasticity, the plain loop)
  LLAMA_SAVE_EVERY / LLAMA_CHECK_EVERY  elastic cadence (default 2 / 10)
  LLAMA_STEP_SLEEP  seconds of pacing between steps (default 0)
  LLAMA_PROGRESS_EVERY  print "progress: batch N" every N batches (default off)
  LLAMA_MESH    parallelism spec, e.g. "fsdp=2" or "fsdp=2,tensor=2,sequence=2"
                (default: pure data parallelism over every rank). The port
                shards over data, fsdp, tensor and sequence; expert and pipe
                are replica axes (the Llama names neither, as in the JAX
                package). Heads that tensor does not divide and a sequence
                that sequence does not divide raise before any rendezvous.
                LLAMA_MESH_DCN adds slice counts ("data=2").

The executor launches one process per host. It runs one rank per local
chip: with ``chips_per_host`` above 1 it spawns that many ranks (the
``spawn`` start method) and exits 75 if any rank did, else with the first
non-zero exit code. A checkpoint dir runs ``ops.elastic.run_elastic``:
exit 75 on a membership change or SIGTERM (forwarded to the ranks), 0 when
done. With no mesh, no checkpoint dir and one host and chip, it is the
plain single-device loop with no process group.

    python -m mpi_operator_tpu_torch.workers.llama_worker [--device cpu]

Runs on CUDA; ``--device cpu`` (``main(device="cpu")``) is the explicit CPU
run the operator's CPU tests use. The device is never read from
``TPUJOB_ACCELERATOR``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Mapping, Optional, Union

import torch
import torch.distributed as dist

from mpi_operator_tpu_torch.kernels import flash_attention
from mpi_operator_tpu_torch.models import llama
from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
from mpi_operator_tpu_torch.ops.elastic import EXIT_RESTART, ElasticConfig, run_elastic
from mpi_operator_tpu_torch.parallel.sharding import check_head_split
from mpi_operator_tpu_torch.runtime import bootstrap
from mpi_operator_tpu_torch.runtime.topology import (
    AXIS_SEQ,
    AXIS_TENSOR,
    MeshPlan,
    mesh_from_context,
    mesh_sizes,
)

CONFIGS = {
    "tiny": llama.tiny,
    "bench": llama.bench_single_chip,
    "8b": llama.llama3_8b,
}


def main(
    device: Union[str, torch.device, None] = None,
    environ: Optional[Mapping[str, str]] = None,
    local_rank: int = 0,
    on_step: Optional[Callable[[int], None]] = None,
) -> dict:
    """Train and return the JSON record (printed by host 0's first rank).
    ``on_step``, where given, is called with i before step i of the plain
    loop and with the step count after its last step (profile_llama's
    per-rank timing of a gang)."""
    env = os.environ if environ is None else environ
    mesh_spec = env.get("LLAMA_MESH", "").strip()
    dcn_spec = env.get("LLAMA_MESH_DCN", "").strip()
    if dcn_spec and not mesh_spec:
        raise SystemExit("LLAMA_MESH_DCN requires LLAMA_MESH to be set")
    plan = MeshPlan.parse(mesh_spec, dcn_spec) if mesh_spec else None
    if plan is not None:
        sizes = dict(plan.ordered())
        cfg = CONFIGS[env.get("LLAMA_CONFIG", "tiny")]()
        check_head_split(cfg.n_heads, cfg.n_kv_heads, sizes.get(AXIS_TENSOR, 1))
        n_seq = sizes.get(AXIS_SEQ, 1)
        if int(env.get("LLAMA_SEQ", "64")) % n_seq:
            raise ValueError(f"LLAMA_SEQ={env.get('LLAMA_SEQ', '64')} does not split over "
                             f"sequence={n_seq}")
    ctx = bootstrap.context_from_env(env)
    # explicit manifest path wins; otherwise the per-job directory on the
    # shared checkpoint volume the node agent advertised (--ckpt-dir)
    ckpt_dir = env.get("LLAMA_CKPT", "") or bootstrap.default_checkpoint_dir(ctx, env) or ""
    device = bootstrap.initialize(ctx, device=device, environ=env, local_rank=local_rank,
                                  group=plan is not None or bool(ckpt_dir))
    try:
        return _train(env, ctx, device, plan, ckpt_dir, local_rank, on_step)
    finally:
        bootstrap.shutdown()


def _train(env, ctx, device, plan, ckpt_dir, local_rank, on_step) -> dict:
    gang = dist.is_initialized()
    mesh = mesh_from_context(ctx, plan, device.type) if gang else None
    cfg = CONFIGS[env.get("LLAMA_CONFIG", "tiny")]()
    per_chip = int(env.get("LLAMA_BATCH", "2"))
    seq_len = int(env.get("LLAMA_SEQ", "64"))
    steps = int(env.get("LLAMA_STEPS", "6"))
    pace = float(env.get("LLAMA_STEP_SLEEP", "0") or 0)
    progress_every = int(env.get("LLAMA_PROGRESS_EVERY", "0") or 0)
    reports = ctx.is_coordinator and local_rank == 0
    global_batch = per_chip * (dist.get_world_size() if gang else 1)

    trainer = Trainer(
        llama.loss_fn,
        TrainerConfig(learning_rate=3e-4, optimizer="adamw", grad_clip_norm=1.0),
        mesh=mesh,
    )

    def batches():
        tokens = synthetic_tokens(global_batch=global_batch, seq_len=seq_len, vocab=cfg.vocab)
        for i, b in enumerate(tokens):
            if pace:
                time.sleep(pace)
            if progress_every and i and i % progress_every == 0 and reports:
                print(f"progress: batch {i}", flush=True)
            yield make_global_batch(b, device, mesh)

    def init_state():
        model = llama.init(cfg, torch.Generator(device=device).manual_seed(0), device)
        return trainer.init_state(model)

    flash_attention.reset_launches()
    restore_s = 0.0
    t0 = time.perf_counter()
    if ckpt_dir:
        result = run_elastic(
            trainer, batches(), total_steps=steps, init_state=init_state,
            config=ElasticConfig(
                checkpoint_dir=ckpt_dir,
                save_interval_steps=int(env.get("LLAMA_SAVE_EVERY", "2")),
                membership_check_every=int(env.get("LLAMA_CHECK_EVERY", "10")),
            ),
        )
        outcome, last_step, start_step = result.outcome, result.last_step, result.start_step
        losses, restore_s = result.losses, result.restore_s
    else:
        state, it, losses = init_state(), batches(), []
        for i in range(steps):
            if on_step is not None:
                on_step(i)
            state, metrics = trainer.train_step(state, next(it))
            losses.append(metrics["loss"])
        if on_step is not None:
            on_step(steps)
        losses = [float(x) for x in losses]  # waits for the device
        outcome, last_step, start_step = "done", steps, 0
    dt = time.perf_counter() - t0

    record = {
        "workload": "llama",
        "outcome": outcome,
        "step": last_step,
        # step this incarnation resumed from (0 = fresh start)
        "start_step": start_step,
        "loss": losses[-1] if losses else None,
        "losses": losses,
        "tokens_per_sec": round(global_batch * (last_step - start_step) * seq_len / dt, 1),
        "hosts": ctx.num_hosts,
        "backend": device.type,
        "mesh": ",".join(f"{a}={s}" for a, s in mesh_sizes(mesh).items() if s > 1)
        if mesh is not None else "",
        "restore_s": restore_s,
        # this rank's launches of each flash kernel in the run (0 on the CPU)
        "kernel_launches": dict(flash_attention.launches),
    }
    if reports:
        print(json.dumps(record), flush=True)
    return record


def exit_code(record: dict) -> int:
    return EXIT_RESTART if record["outcome"] == "restart" else 0


def _rank_main(local_rank: int, device: str) -> None:
    sys.exit(exit_code(main(device=device, local_rank=local_rank)))


def _combined_exit(codes) -> int:
    """75 if any rank asked for a restart, else the first non-zero code."""
    if EXIT_RESTART in codes:
        return EXIT_RESTART
    return next((c for c in codes if c), 0)


def run_host(device: Optional[str] = None) -> int:
    """This host's ranks: one in this process, or ``chips_per_host`` spawned
    ones. Returns the host's exit code."""
    ctx = bootstrap.context_from_env()
    local = max(ctx.chips_per_host, 1) if device == "cpu" else ctx.local_chips()
    if local <= 1:
        return exit_code(main(device=device))
    if ctx.num_hosts == 1 and not ctx.coordinator_address:
        os.environ[bootstrap.ENV_COORDINATOR] = f"127.0.0.1:{bootstrap.free_port()}"
    return _combined_exit(bootstrap.run_local_ranks(_rank_main, local, (device,)))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu: run on the CPU explicitly (default: cuda)")
    sys.exit(run_host(ap.parse_args().device))
