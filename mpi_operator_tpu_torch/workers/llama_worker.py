"""Llama decoder training worker: one rank per CUDA device, sharded with
FSDP2 over the job's mesh, elastic through checkpoints.

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
  LLAMA_MESH    parallelism spec, e.g. "fsdp=2" or "data=2,fsdp=2"
                (default: pure data parallelism over every rank). The port
                shards over data and fsdp; tensor, sequence, expert and pipe
                above 1 raise. LLAMA_MESH_DCN adds slice counts ("data=2").

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
import multiprocessing
import os
import signal
import socket
import sys
import time
from typing import Mapping, Optional, Union

import torch
import torch.distributed as dist

from mpi_operator_tpu_torch.kernels import flash_attention
from mpi_operator_tpu_torch.models import llama
from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
from mpi_operator_tpu_torch.ops.elastic import EXIT_RESTART, ElasticConfig, run_elastic
from mpi_operator_tpu_torch.parallel.sharding import refuse_unported_axes
from mpi_operator_tpu_torch.runtime import bootstrap
from mpi_operator_tpu_torch.runtime.topology import MeshPlan, mesh_from_context, mesh_sizes

CONFIGS = {
    "tiny": llama.tiny,
    "bench": llama.bench_single_chip,
    "8b": llama.llama3_8b,
}


def main(
    device: Union[str, torch.device, None] = None,
    environ: Optional[Mapping[str, str]] = None,
    local_rank: int = 0,
) -> dict:
    """Train and return the JSON record (printed by host 0's first rank)."""
    env = os.environ if environ is None else environ
    mesh_spec = env.get("LLAMA_MESH", "").strip()
    dcn_spec = env.get("LLAMA_MESH_DCN", "").strip()
    if dcn_spec and not mesh_spec:
        raise SystemExit("LLAMA_MESH_DCN requires LLAMA_MESH to be set")
    plan = MeshPlan.parse(mesh_spec, dcn_spec) if mesh_spec else None
    if plan is not None:
        refuse_unported_axes(dict(plan.ordered()))
    ctx = bootstrap.context_from_env(env)
    # explicit manifest path wins; otherwise the per-job directory on the
    # shared checkpoint volume the node agent advertised (--ckpt-dir)
    ckpt_dir = env.get("LLAMA_CKPT", "") or bootstrap.default_checkpoint_dir(ctx, env) or ""
    device = bootstrap.initialize(ctx, device=device, local_rank=local_rank,
                                  group=plan is not None or bool(ckpt_dir))
    try:
        return _train(env, ctx, device, plan, ckpt_dir, local_rank)
    finally:
        bootstrap.shutdown()


def _train(env, ctx, device, plan, ckpt_dir, local_rank) -> dict:
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
        for _ in range(steps):
            state, metrics = trainer.train_step(state, next(it))
            losses.append(metrics["loss"])
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
        os.environ[bootstrap.ENV_COORDINATOR] = f"127.0.0.1:{_free_port()}"
    spawn = multiprocessing.get_context("spawn")
    procs = [spawn.Process(target=_rank_main, args=(r, device)) for r in range(local)]

    def forward(sig, frame):
        for p in procs:
            if p.pid is not None and p.is_alive():
                os.kill(p.pid, sig)

    signal.signal(signal.SIGTERM, forward)
    for p in procs:
        p.start()
    failed_at = None
    while any(p.is_alive() for p in procs):
        for p in procs:
            p.join(timeout=0.2)
        if failed_at is None and any(p.exitcode not in (None, 0, EXIT_RESTART) for p in procs):
            failed_at = time.monotonic()
        # a rank that died leaves the others in a collective: end them
        if failed_at is not None and time.monotonic() - failed_at > 10.0:
            for p in procs:
                if p.is_alive():
                    p.kill()
    return _combined_exit([p.exitcode for p in procs])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu: run on the CPU explicitly (default: cuda)")
    sys.exit(run_host(ap.parse_args().device))
