"""Per-step goodput telemetry: stall-attributed wall-second buckets for
the training loop.

Port of ``mpi_operator_tpu/runtime/stepstats.py``: :class:`StepStatsRecorder`
and the executor contract (``TPUJOB_STEPSTATS_FILE``,
``TPUJOB_STEPSTATS_INTERVAL``), with the ``TRAIN_BUCKETS`` taxonomy and the
``bounded_train_stats`` blob it imports from
``mpi_operator_tpu/machinery/objects.py``. The executor mirrors the file the
worker flushes into ``pod.status.train_stats`` unchanged, so the blob is the
JAX package's byte for byte. The ops/elastic.py loop threads it through
its phases:

- ``compile``  — the first compute phase (kernel build, allocator and
  cuBLAS warm-up, the first step);
- ``input``    — waiting on ``next(batches)``;
- ``compute``  — the train step's dispatch, plus the wait on the device
  that bounds how far the host runs ahead (ops/elastic.py);
- ``sync``     — the gang-uniform membership/preemption all-gather;
- ``ckpt``     — checkpoint saves (periodic and forced).

The port has no persistent compile cache yet, so the blob never carries
``compile_cache``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional

log = logging.getLogger("tpujob.stepstats")

# the executor→worker contract: where the worker flushes its stats blob
ENV_STATS_FILE = "TPUJOB_STEPSTATS_FILE"
ENV_STATS_INTERVAL = "TPUJOB_STEPSTATS_INTERVAL"
DEFAULT_FLUSH_INTERVAL = 1.0

# copies of mpi_operator_tpu/machinery/objects.py's bucket taxonomy and
# bounded blob constructor
TRAIN_BUCKETS = ("compile", "input", "compute", "sync", "ckpt")
_PROFILE_KEYS = ("id", "state", "dir")


def _r3(v) -> float:
    try:
        return round(float(v), 3)
    except (TypeError, ValueError):
        return 0.0


def _i(v) -> int:
    try:
        return int(v or 0)
    except (TypeError, ValueError):
        return 0


def bounded_train_stats(step=0, steps=0, step_p50_ms=0.0, buckets=None,
                        profile=None, compile_cache=None,
                        **_ignored) -> Dict[str, object]:
    """A pod's ``status.train_stats`` blob: fixed key set, rounded floats,
    bucket keys clamped to :data:`TRAIN_BUCKETS`, profile ack clamped to
    short strings. ``step`` is the global step, ``steps`` and ``buckets``
    this incarnation's."""
    if not isinstance(buckets, dict):
        buckets = {}
    out: Dict[str, object] = {
        "step": _i(step),
        "steps": _i(steps),
        "step_p50_ms": _r3(step_p50_ms),
        "buckets": {
            k: _r3(buckets.get(k, 0.0)) for k in TRAIN_BUCKETS
        },
    }
    if isinstance(profile, dict) and profile:
        out["profile"] = {
            k: str(profile.get(k, ""))[:256] for k in _PROFILE_KEYS
        }
    if isinstance(compile_cache, dict) and compile_cache:
        out["compile_cache"] = {
            "hits": _i(compile_cache.get("hits")),
            "misses": _i(compile_cache.get("misses")),
        }
    return out


class StepStatsRecorder:
    """Accumulates per-step bucket attribution inside a training loop::

        stats = StepStatsRecorder.from_env()
        with stats.phase("input"):
            batch = next(batches)
        with stats.phase("compute"):     # first compute → "compile"
            state, m = trainer.train_step(state, batch)
        stats.step_done(step)

    ``clock`` is injectable for deterministic tests. A recorder with no
    path still accumulates (callers read :meth:`snapshot`) but never
    touches the filesystem.
    """

    def __init__(self, path: str = "", *, interval: Optional[float] = None,
                 window: int = 64, clock=time.perf_counter):
        self.path = path or ""
        self.interval = (DEFAULT_FLUSH_INTERVAL if interval is None
                         else max(0.0, interval))
        self._clock = clock
        self._buckets: Dict[str, float] = {k: 0.0 for k in TRAIN_BUCKETS}
        self._step = 0    # global step (checkpoint-resumed jobs pass it in)
        self._steps = 0   # steps run by THIS incarnation (resets on restart)
        self._times: collections.deque = collections.deque(maxlen=window)
        self._step_start = clock()
        self._compiled = False
        self._profile: Optional[Dict[str, str]] = None
        self._last_flush = 0.0
        self._warned = False

    @classmethod
    def from_env(cls, env=None) -> "StepStatsRecorder":
        env = os.environ if env is None else env
        try:
            interval = float(env.get(ENV_STATS_INTERVAL, "") or
                             DEFAULT_FLUSH_INTERVAL)
        except ValueError:
            interval = DEFAULT_FLUSH_INTERVAL
        return cls(env.get(ENV_STATS_FILE, ""), interval=interval)

    @property
    def enabled(self) -> bool:
        return bool(self.path)

    @contextlib.contextmanager
    def phase(self, bucket: str):
        """Attribute the enclosed wall time to ``bucket``. The FIRST
        ``compute`` phase lands in ``compile`` instead: the first step's
        wall time is build + warm-up + run."""
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            if bucket == "compute" and not self._compiled:
                self._compiled = True
                bucket = "compile"
            self._buckets[bucket] = self._buckets.get(bucket, 0.0) + dt

    def step_done(self, step: Optional[int] = None) -> None:
        """One step finished: record its wall time (everything since the
        previous ``step_done``) and flush if the cadence says so."""
        now = self._clock()
        self._times.append((now - self._step_start) * 1e3)
        self._step_start = now
        self._steps += 1
        self._step = self._step + 1 if step is None else int(step)
        if self.path and now - self._last_flush >= self.interval:
            self.flush(now=now)

    def set_profile(self, req_id: str, state: str, directory: str) -> None:
        """Record the on-demand profile ack (flushed immediately)."""
        self._profile = {"id": req_id, "state": state, "dir": directory}
        if self.path:
            self.flush(force=True)

    def step_p50_ms(self) -> float:
        if not self._times:
            return 0.0
        ordered = sorted(self._times)
        return ordered[len(ordered) // 2]

    def snapshot(self) -> Dict[str, Any]:
        """The bounded blob (exactly what lands in status.train_stats)."""
        return bounded_train_stats(
            step=self._step, steps=self._steps,
            step_p50_ms=self.step_p50_ms(), buckets=self._buckets,
            profile=self._profile,
        )

    def flush(self, force: bool = False, now: Optional[float] = None) -> None:
        if not self.path:
            return
        now = self._clock() if now is None else now
        if not force and now - self._last_flush < self.interval:
            return
        self._last_flush = now
        payload = self.snapshot()
        payload["pid"] = os.getpid()
        payload["t"] = time.time()
        try:
            tmp = f"{self.path}.{os.getpid()}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)  # readers never see a torn blob
        except OSError:
            if not self._warned:
                # a full disk must not take the training loop down
                self._warned = True
                log.warning("step-stats flush to %s failed", self.path,
                            exc_info=True)

    def close(self) -> None:
        if self.path:
            self.flush(force=True)


def read_stats(path: str) -> Optional[Dict[str, Any]]:
    """Read a flushed stats blob; None when absent/unreadable/partial."""
    try:
        with open(path, encoding="utf-8") as f:
            out = json.load(f)
    except (OSError, ValueError):
        return None
    return out if isinstance(out, dict) else None
