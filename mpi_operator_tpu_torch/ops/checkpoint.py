"""Checkpoint / resume over ``torch.distributed.checkpoint`` (DCP).

Port of ``mpi_operator_tpu/ops/checkpoint.py`` (orbax there), with its
methods and semantics:

- ``save`` honours ``save_interval_steps`` and ``max_to_keep`` and is
  asynchronous (``dcp.async_save``): it returns once the state is copied to
  host memory; the write to disk overlaps the next steps, and only
  :meth:`CheckpointManager.wait` (the sanctioned seams) blocks on it;
- ``restore`` is reshard-on-load: the tensors of the template state (its
  DTensors laid out on the *current* mesh) are filled in place, so a
  checkpoint written by 4 ranks restores onto 2;
- step directories are ``<dir>/<step>/``, as orbax writes them.

A step is committed when its ``.metadata`` file exists: DCP writes it last,
once every rank's shards are on disk, through a temporary file renamed into
place. :meth:`latest_step` counts only committed steps, so a save killed
midway is never restored.

Every rank of the gang calls each method, the constructor included: it
makes the manager's own gloo group, since an async save's collectives run
on a background thread and would interleave with the training step's on a
shared group.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from mpi_operator_tpu_torch.ops.trainer import TrainState

_COMMIT_MARKER = ".metadata"


def state_dict(state: TrainState) -> Dict[str, Any]:
    """What a checkpoint holds: the step, the model's parameters and the
    optimizer state keyed by parameter name (all by reference, so loading
    into it fills the state in place)."""
    return {"step": state.step, "model": state.params.state_dict(), "opt": state.opt_state}


class CheckpointManager:
    """Step-numbered DCP checkpoints under one directory."""

    def __init__(
        self,
        directory: str,
        *,
        max_to_keep: int = 3,
        save_interval_steps: int = 1000,
    ):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._pending: Optional[Future] = None
        self._group = dist.new_group(backend="gloo") if dist.is_initialized() else None
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def committed_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(self._path(int(name)),
                                                              _COMMIT_MARKER)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """The newest committed step (a save in flight is not one until
        :meth:`wait` returns); None when there is none."""
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, *, force: bool = False) -> bool:
        """Save if ``step`` hits the interval (or ``force``). Returns after the
        device→host copy; the disk write overlaps later steps. A save in
        flight is waited for first (as orbax's ``save`` does)."""
        if not force and step % self.save_interval_steps:
            return False
        self.wait()
        self._prune(keep=self.max_to_keep - 1)
        if self._is_writer():
            # a step saved again is uncommitted until this save's marker lands
            marker = os.path.join(self._path(step), _COMMIT_MARKER)
            if os.path.exists(marker):
                os.remove(marker)
        self._pending = dcp.async_save(state_dict(state), checkpoint_id=self._path(step),
                                       process_group=self._group)
        return True

    def restore(self, state: TrainState, *, step: Optional[int] = None) -> TrainState:
        """Load ``step`` (default: the latest committed) into ``state``'s
        tensors, resharded to their current layout; returns ``state``.
        Raises ``FileNotFoundError`` when there is no checkpoint."""
        # pre-restore fence (a sanctioned wait seam, oplint CKP001)
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        sd = state_dict(state)
        dcp.load(sd, checkpoint_id=self._path(step), process_group=self._group)
        state.step = int(sd["step"])
        return state

    def wait(self) -> None:
        """Block until the save in flight, if any, has committed."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    @staticmethod
    def _is_writer() -> bool:
        return not dist.is_initialized() or dist.get_rank() == 0

    def _prune(self, keep: int) -> None:
        """Rank 0 removes all but the newest ``keep`` committed steps."""
        if not self._is_writer():
            return
        for step in self.committed_steps()[:-keep or None]:
            shutil.rmtree(self._path(step), ignore_errors=True)

    def close(self) -> None:
        self.wait()
