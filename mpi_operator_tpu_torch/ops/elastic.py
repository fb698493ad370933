"""Elastic training loop: membership changes → checkpoint → exit 75 → resume.

Port of ``mpi_operator_tpu/ops/elastic.py``, with the same protocol:

  1. every rank trains the gang's sharded step;
  2. a membership source (the controller-projected hostfile, or any
     callable) reports the *desired* number of hosts;
  3. on a change, or on SIGTERM at any rank, every rank force-checkpoints
     at the same step and exits with EXIT_RESTART (75), a retryable code
     under ``restart_policy: ExitCode``;
  4. the controller re-runs the gang at the new size; the ranks restore the
     checkpoint (reshard-on-load, ops/checkpoint.py) and go on from its
     step.

Membership counts hosts, as ``jax.process_count()`` does there: the port
runs one rank per chip, so the hostfile's lines are compared with
``bootstrap.process_count()``, never with the world size.

The operator's on-demand profiling (``StepProfiler``,
``ProfileRequestWatcher``) belongs to the ``ops/profiling`` slice, not
ported yet: the loop marks the seam where it hooks in.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

from mpi_operator_tpu_torch.ops.checkpoint import CheckpointManager
from mpi_operator_tpu_torch.ops.trainer import Trainer, TrainState
from mpi_operator_tpu_torch.runtime import bootstrap
from mpi_operator_tpu_torch.runtime.stepstats import StepStatsRecorder

# EX_TEMPFAIL: the "re-run me" exit code workers use on membership change.
EXIT_RESTART = 75

ENV_CONFIG_DIR = "TPUJOB_CONFIG_DIR"
HOSTFILE_NAME = "hostfile"


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    checkpoint_dir: str = ""
    save_interval_steps: int = 100
    membership_check_every: int = 10


@dataclasses.dataclass
class ElasticResult:
    outcome: str  # "done" | "restart"
    state: Any
    last_step: int
    metrics: Optional[Dict[str, float]] = None
    start_step: int = 0  # step this incarnation resumed from (0 = fresh)
    losses: List[float] = dataclasses.field(default_factory=list)  # one per step run
    restore_s: float = 0.0  # wall seconds of the checkpoint restore (0: none)

    @property
    def steps_run(self) -> int:
        """Steps executed by THIS process (excludes restored progress)."""
        return self.last_step - self.start_step

    @property
    def exit_code(self) -> int:
        return 0 if self.outcome == "done" else EXIT_RESTART


# Preemption arrives as SIGTERM with a kill grace behind it. The handler only
# sets a flag; the loop folds it into its gang-uniform check, so every rank
# force-checkpoints at the SAME step (a rank acting on its own signal timing
# would leave the others waiting in a collective).
_PREEMPTED = threading.Event()


def install_preemption_handler() -> None:
    """Route SIGTERM into the loop's checkpoint-and-exit path. Main-thread
    only (signal module contract); a no-op elsewhere."""
    try:
        signal.signal(signal.SIGTERM, lambda sig, frame: _PREEMPTED.set())
    except ValueError:
        pass  # not the main thread: the host process owns signal routing


def declared_world_size() -> int:
    """Desired gang size in hosts per the controller: hostfile lines in the
    projected config dir, else ``TPUJOB_NUM_HOSTS``."""
    cfg_dir = os.environ.get(ENV_CONFIG_DIR, "")
    path = os.path.join(cfg_dir, HOSTFILE_NAME)
    if not cfg_dir or not os.path.exists(path):
        return int(os.environ.get("TPUJOB_NUM_HOSTS", "1"))
    with open(path) as f:
        return sum(1 for line in f if line.strip())


def _final_checkpoint(mgr: CheckpointManager, stats: StepStatsRecorder,
                      step: int, state: Any) -> None:
    """THE sanctioned blocking-wait seam (oplint CKP001 in the JAX
    package): the SIGTERM/membership force-checkpoint and the terminal exit
    are the only places the loop blocks on a checkpoint commit. The save in
    flight is committed first, so ``latest_step`` sees it."""
    with stats.phase("ckpt"):
        mgr.wait()
        if mgr.latest_step() != step:
            mgr.save(step, state, force=True)
        mgr.wait()


def _gang_state(membership: Callable[[], int]) -> "tuple[int, bool]":
    """(desired hosts, preemption requested) as ONE gang-uniform decision:
    membership is rank 0's (host 0's) view, preemption the OR over every
    rank. One all-gather of a CPU tensor (gloo on the card's group too)."""
    mine = torch.tensor([membership(), int(_PREEMPTED.is_set())], dtype=torch.int64)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return int(mine[0]), bool(mine[1])
    gathered = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, mine)
    return int(gathered[0][0]), any(bool(g[1]) for g in gathered)


def _device_event(t: torch.Tensor):
    """A CUDA event recorded after the work that produces ``t`` (None on
    the CPU, where the step has finished when it returns)."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def run_elastic(
    trainer: Trainer,
    batches: Iterator[Any],
    *,
    total_steps: int,
    config: ElasticConfig,
    init_state: Callable[[], TrainState],
    membership: Callable[[], int] = declared_world_size,
    current_world: Optional[int] = None,
) -> ElasticResult:
    """Train to ``total_steps`` or until membership changes.

    ``init_state`` builds the state at step 0 (sharded on the current
    mesh); the latest checkpoint, if any, is restored into it. Returns
    "restart" (the caller exits EXIT_RESTART) or "done"."""
    if current_world is None:
        current_world = bootstrap.process_count()

    # clear-then-install: a fresh incarnation cannot still be preempted by a
    # signal delivered to a previous run in this process
    _PREEMPTED.clear()
    install_preemption_handler()
    mgr = CheckpointManager(config.checkpoint_dir,
                            save_interval_steps=config.save_interval_steps)
    state = init_state()
    restore_s = 0.0
    if mgr.latest_step() is not None:
        t0 = time.perf_counter()
        state = mgr.restore(state)
        restore_s = time.perf_counter() - t0

    step = start_step = state.step
    metrics = None
    losses = []
    # Eager CUDA returns before the step ends. JAX's compute phase includes
    # the block on the previous step's donated buffers; here the compute
    # phase of step N+1 waits on an event recorded at the end of step N-1,
    # so the host runs at most two steps ahead and `compute` measures the
    # device's steady-state step time, not the launch time.
    in_flight: collections.deque = collections.deque()
    stats = StepStatsRecorder.from_env()
    if bootstrap.local_rank() != 0:
        stats.path = ""  # one blob per host: its first rank's
    # ops/profiling seam (not ported yet): StepProfiler.observe and
    # ProfileRequestWatcher.observe/poll hook in after each step and each
    # membership check, as in the JAX loop.
    try:
        while step < total_steps:
            with stats.phase("input"):
                batch = next(batches)
            with stats.phase("compute"):
                state, metrics = trainer.train_step(state, batch)
                in_flight.append(_device_event(metrics["loss"]))
                if len(in_flight) > 2:
                    ev = in_flight.popleft()
                    if ev is not None:
                        ev.synchronize()
            losses.append(metrics["loss"])
            step += 1
            stats.step_done(step)
            if step % config.save_interval_steps == 0:
                # async save: returns after the device→host copy; the disk
                # write overlaps the next steps
                with stats.phase("ckpt"):
                    mgr.save(step, state)
            if step % config.membership_check_every == 0:
                with stats.phase("sync"):
                    want, preempted = _gang_state(membership)
                if preempted or want != current_world:
                    # force-checkpoint BEFORE exiting: for preemption this
                    # runs inside the eviction grace window
                    _final_checkpoint(mgr, stats, step, state)
                    return _result("restart", state, step, metrics, start_step, losses,
                                   restore_s)
        _final_checkpoint(mgr, stats, step, state)
    finally:
        stats.close()
        mgr.close()
    return _result("done", state, step, metrics, start_step, losses, restore_s)


def _result(outcome, state, step, metrics, start_step, losses, restore_s) -> ElasticResult:
    return ElasticResult(
        outcome, state, step,
        {k: float(v) for k, v in (metrics or {}).items()},
        start_step=start_step,
        losses=[float(x) for x in losses],
        restore_s=restore_s,
    )
