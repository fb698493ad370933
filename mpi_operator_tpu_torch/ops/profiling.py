"""Profiler hooks for the training loop: a fixed step window from the env,
and captures on request from the operator.

Port of ``mpi_operator_tpu/ops/profiling.py``, with the same contract; the
backend is ``torch.profiler`` (CPU activity, and CUDA activity when a card
is present) in place of ``jax.profiler``, and a capture is a Chrome trace
(``trace.json``) per rank:

- :class:`StepProfiler`: ``TPUJOB_PROFILE_DIR`` (per-host subdir
  appended), ``TPUJOB_PROFILE_START`` (first step, default 10) and
  ``TPUJOB_PROFILE_STEPS`` (how many, default 5) on a job's worker template
  make every rank trace that window with no code change.
- :class:`ProfileRequestWatcher`: ``ctl profile <job> --steps N`` stamps
  the profile-request annotation, the controller projects it into the
  job's config dir as the ``profile`` file (beside the hostfile the
  membership check reads), and the watcher captures N steps into the job's
  artifact dir, acking ``capturing`` / ``done`` / ``failed`` through the
  step-stats blob's ``profile`` entry. A non-empty capture dir on the
  shared volume is the durable "already captured" marker: a relaunched
  worker that re-reads an old request acks ``done`` and captures nothing.
  A profiler that fails acks ``failed`` and the loop goes on.

A capture goes to ``<dir>/host<h>``, or ``<dir>/host<h>/rank<l>`` where a
host runs several ranks (each rank traces its own process).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Any, Dict, Optional

from mpi_operator_tpu_torch.runtime import bootstrap

log = logging.getLogger("tpujob.profiling")

ENV_DIR = "TPUJOB_PROFILE_DIR"
ENV_START = "TPUJOB_PROFILE_START"
ENV_STEPS = "TPUJOB_PROFILE_STEPS"

# the config-dir file the controller projects the profile request into
PROFILE_REQUEST_FILE = "profile"
TRACE_FILE = "trace.json"


def rank_subdir(host: int) -> str:
    """This rank's capture subdir: ``host<h>``, plus ``rank<l>`` where the
    host runs several ranks."""
    sub = f"host{host}"
    if bootstrap.local_chips() > 1:
        sub = os.path.join(sub, f"rank{bootstrap.local_rank()}")
    return sub


class TorchTrace:
    """One ``torch.profiler`` capture at a time: :meth:`start` into a
    directory, :meth:`stop` writes its Chrome trace there."""

    def __init__(self):
        self._prof = None
        self._dir = ""

    def start(self, directory: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        self._prof, self._dir = prof, directory

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.stop()
        os.makedirs(self._dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self._dir, TRACE_FILE))


class StepProfiler:
    """Drive from a training loop: call observe(step) once per step; the
    trace starts and stops itself around the configured window. A no-op
    when TPUJOB_PROFILE_DIR is unset."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory if directory is not None else os.environ.get(ENV_DIR, "")
        self.start_step = int(os.environ.get(ENV_START, "10") or "10")
        self.num_steps = max(1, int(os.environ.get(ENV_STEPS, "5") or "5"))
        self._trace = TorchTrace()
        self._active = False
        self._done = False

    @property
    def enabled(self) -> bool:
        return bool(self.directory)

    def observe(self, step: int) -> None:
        if not self.enabled or self._done:
            return
        if not self._active and self.start_step <= step < self.start_step + self.num_steps:
            self._trace.start(os.path.join(self.directory,
                                           rank_subdir(bootstrap.process_index())))
            self._active = True
        elif self._active and step >= self.start_step + self.num_steps:
            self.close()

    def close(self) -> None:
        if self._active:
            self._trace.stop()
            self._active = False
            self._done = True


class ProfileRequestWatcher:
    """The operator-triggered capture: polls the projected request file at
    the membership-check cadence, captures a trace for the requested step
    window, and acks progress through the step-stats recorder.

    Drive from a training loop::

        watcher = ProfileRequestWatcher(stats, out_root=...)
        ...
        watcher.observe(step)           # every step (no-op unless active)
        if step % check_every == 0:
            watcher.poll(step)          # re-read the projected request

    ``start_trace``/``stop_trace`` are injectable (the tests drive the state
    machine with fakes); the defaults are a :class:`TorchTrace`.
    """

    def __init__(self, stats=None, *, config_dir: Optional[str] = None,
                 out_root: Optional[str] = None,
                 host_index: Optional[int] = None,
                 start_trace=None, stop_trace=None):
        self.stats = stats  # StepStatsRecorder (acks ride its blob)
        self.config_dir = (
            config_dir if config_dir is not None
            else os.environ.get("TPUJOB_CONFIG_DIR", "")
        )
        self.out_root = out_root or os.path.join(
            tempfile.gettempdir(), "tpujob-profiles",
            os.environ.get("TPUJOB_NAMESPACE", "default")
            + "-" + os.environ.get("TPUJOB_NAME", "job"),
        )
        self._host_index = host_index
        trace = TorchTrace()
        self._start = start_trace or trace.start
        self._stop = stop_trace or trace.stop
        self._handled: Optional[str] = None  # last request id acted on
        self._active: Optional[Dict[str, Any]] = None  # {id, until, dir}

    def _host(self) -> int:
        return bootstrap.process_index() if self._host_index is None else self._host_index

    def _read_request(self) -> Optional[Dict[str, Any]]:
        if not self.config_dir:
            return None
        path = os.path.join(self.config_dir, PROFILE_REQUEST_FILE)
        try:
            with open(path, encoding="utf-8") as f:
                raw = f.read().strip()
        except OSError:
            return None
        if not raw:
            return None
        try:
            req = json.loads(raw)
        except ValueError:
            log.warning("malformed profile request ignored: %.128s", raw)
            return None
        if not isinstance(req, dict) or not req.get("id"):
            return None
        return req

    def _ack(self, req_id: str, state: str, directory: str) -> None:
        if self.stats is not None:
            self.stats.set_profile(req_id, state, directory)

    def poll(self, step: int) -> None:
        """Check the projected request file (membership-check cadence: one
        read per check, never per step)."""
        if self._active is not None:
            return
        req = self._read_request()
        # compare normalised: a hand-stamped numeric id must not read as new
        # on every poll and restart the capture
        if req is None or str(req["id"]) == self._handled:
            return
        self._handled = str(req["id"])
        try:
            steps = max(1, int(req.get("steps", 5)))
        except (TypeError, ValueError):
            steps = 5
        directory = os.path.join(self.out_root, self._handled, rank_subdir(self._host()))
        try:
            already = os.path.isdir(directory) and os.listdir(directory)
        except OSError:
            already = False
        if already:
            # the annotation is never cleared, and a relaunched worker
            # re-reads it with fresh state: the capture on the shared volume
            # says it was taken here, so ack done and keep the trace
            log.info("profile %s: already captured (%s); skipping", self._handled, directory)
            self._ack(self._handled, "done", directory)
            return
        try:
            os.makedirs(directory, exist_ok=True)
            self._start(directory)
        except Exception as e:
            # a broken profiler must not take the training loop down; the
            # failure is the ack the requester sees
            log.warning("profile capture failed to start: %s", e)
            self._ack(self._handled, "failed", directory)
            return
        self._active = {"id": self._handled, "until": step + steps, "dir": directory}
        log.info("profile %s: capturing %d steps into %s", self._handled, steps, directory)
        self._ack(self._handled, "capturing", directory)

    def observe(self, step: int) -> None:
        """Per-step hook: stops the capture once its window has passed."""
        act = self._active
        if act is None or step < act["until"]:
            return
        self._finish("done")

    def _finish(self, state: str) -> None:
        act, self._active = self._active, None
        if act is None:
            return
        try:
            self._stop()
        except Exception as e:
            log.warning("profile trace stop failed: %s", e)
            state = "failed"
        self._ack(act["id"], state, act["dir"])
        log.info("profile %s: %s (%s)", act["id"], state, act["dir"])

    def close(self) -> None:
        """End of the run: a capture in flight stops and acks (a gang that
        restarts mid-capture leaves a shorter trace, not a wedged
        profiler)."""
        if self._active is not None:
            self._finish("done")
