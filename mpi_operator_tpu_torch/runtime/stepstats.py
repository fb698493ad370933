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

With the persistent kernel cache on (``runtime/compile_cache.py``), the
blob carries its ``compile_cache`` hits and misses, as the JAX package's
does.

The port's spans live here too. :func:`span` names a stretch of host code
(``loop.<bucket>`` for each phase above, ``trainer.*`` in
``ops/trainer.py``, ``data.*`` in ``ops/data.py``); with no
``torch.profiler`` capture running on the calling thread it costs one
check. During a capture (the benchmark's ``--trace 1``,
``TPUJOB_PROFILE_DIR``, ``ctl profile``) it is an event of the capture's
host timeline, on the kernels' clock, and its host seconds add up in
:func:`span_totals`.
:func:`device_mark` is a span's device side: the port's own kernel
``tpujob_span_mark_<point>`` (``kernels/csrc/span_mark.cu``), launched on
the current stream during a capture, so the device trace shows when the
stream reached that point of the step.
:func:`count` is a span's counter: during a capture it adds a device
tensor into a running total on the device (no host sync), and
:func:`counter_totals` reads the totals with the number of train steps they
cover (:func:`count_step`, which ``Trainer.train_step`` calls).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import logging
import os
import time
from typing import Any, Dict, Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

from mpi_operator_tpu_torch.kernels import _build

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


_NULL_SPAN = contextlib.nullcontext()
# span name -> [host seconds, count]; only the capturing thread writes it
_span_totals: Dict[str, list] = {}


class _Span:
    """A span opened during a capture: an event of the capture's host
    timeline, and its host seconds added to :func:`span_totals` when it
    closes."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # an operator-scope event, not record_function's user annotation: the
        # profiler copies a user annotation onto the device timeline as a
        # span over its kernels, where every reader of device operations
        # (busy time, kernel classes) would count it as one
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        total = _span_totals.setdefault(self.name, [0.0, 0])
        total[0] += dt
        total[1] += 1
        return False


def span(name: str):
    """A span named ``name``, for a ``with`` block. With no
    ``torch.profiler`` capture running on the calling thread (the profiler
    records only the thread that started it), one check returns a shared
    null context: nothing is allocated, recorded or launched. During a
    capture the block is an event of the capture's host timeline, on the
    kernels' clock, and its host seconds add to ``span_totals()[name]``."""
    if not _profiler_enabled():
        return _NULL_SPAN
    return _Span(name)


def span_totals() -> Dict[str, Dict[str, float]]:
    """Each span name's host ``seconds`` and ``count`` over the captures
    since :func:`reset_span_totals` (spans outside a capture count
    nothing)."""
    return {name: {"seconds": s, "count": n} for name, (s, n) in _span_totals.items()}


def reset_span_totals() -> None:
    _span_totals.clear()


# counter name -> running total (a device tensor); steps counted meanwhile.
# Like the span totals they outlive the session that counted them.
_counters: Dict[str, torch.Tensor] = {}
_counter_steps = 0


def counting() -> bool:
    """Whether :func:`count` counts now (a capture runs on this thread):
    callers skip computing what it would drop."""
    return _profiler_enabled()


def count(name: str, value: torch.Tensor) -> None:
    """During a capture on the calling thread, add ``value`` (a tensor of
    a fixed shape per name) into the total of counter ``name``, on its
    device and without a host sync; nothing otherwise."""
    if not _profiler_enabled():
        return
    total = _counters.get(name)
    if total is None:
        _counters[name] = value.detach().double().clone()
    else:
        total.add_(value.detach())


def count_step() -> None:
    """One train step ran: counted during a capture, as the counters are."""
    global _counter_steps
    if _profiler_enabled():
        _counter_steps += 1


def counter_totals() -> Dict[str, Any]:
    """``{"steps": train steps counted, "counters": {name: total}}`` since
    :func:`reset_counters`; a total is a float, or a list for a counter of
    several values. Reads the device (a sync)."""
    out = {}
    for name, t in _counters.items():
        out[name] = t.item() if t.dim() == 0 else t.tolist()
    return {"steps": _counter_steps, "counters": out}


def reset_counters() -> None:
    global _counter_steps
    _counters.clear()
    _counter_steps = 0


MARK_KERNEL = "tpujob_span_mark"  # the marks' kernels: MARK_KERNEL + "_" + point
# the trainer's four a step, then models/deepseek_v3's two a layer (before the
# latent attention's projections, and before K1)
MARK_POINTS = ("fwd", "bwd", "opt", "end", "mla_in", "mla_attn")
_mark_lib: Optional[ctypes.CDLL] = None


def load_device_marks(device) -> bool:
    """Build (at its first use in a build directory) and load the mark
    kernels when ``device`` is a CUDA device: set-up's work, so that no
    capture builds them. Returns whether ``device`` takes marks: not off
    CUDA, nor where the kernels do not build (no ``nvcc``), which is
    logged; training goes on without marks."""
    global _mark_lib
    if torch.device(device).type != "cuda":
        return False
    if _mark_lib is None:
        try:
            _mark_lib = _build.typed_library(
                "span_mark", {"tpujob_span_mark_launch": [ctypes.c_int, ctypes.c_void_p]},
                "tpujob_span_mark_error_string")
        except (RuntimeError, OSError):
            log.warning("device marks off: the mark kernels did not build or load",
                        exc_info=True)
            return False
    return True


def device_mark(device, point: str) -> None:
    """During a capture on the calling thread, launch the mark of ``point``
    (one of :data:`MARK_POINTS`: ``tpujob_span_mark_<point>``) on
    ``device``'s current stream; nothing otherwise, nor for a ``device`` of
    None (one that :func:`load_device_marks` refused), nor before the mark
    kernels were loaded (a model's marks outside the trainer's set-up)."""
    if device is None or _mark_lib is None or not _profiler_enabled():
        return
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _mark_lib.tpujob_span_mark_launch(MARK_POINTS.index(point), stream)
    _build.check(_mark_lib, rc, f"{MARK_KERNEL}_{point}")


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
        wall time is build + warm-up + run. The phase is the span
        ``loop.<bucket>``, named by the bucket its time lands in."""
        if bucket == "compute" and not self._compiled:
            self._compiled = True
            bucket = "compile"
        t0 = self._clock()
        try:
            with span("loop." + bucket):
                yield
        finally:
            dt = self._clock() - t0
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
        from mpi_operator_tpu_torch.runtime import compile_cache

        return bounded_train_stats(
            step=self._step, steps=self._steps,
            step_p50_ms=self.step_p50_ms(), buckets=self._buckets,
            profile=self._profile,
            # only when the kernel cache is on: a warm restart's compile
            # bucket reads as warm, not just small
            compile_cache=(compile_cache.cache_stats()
                           if compile_cache.is_configured() else None),
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
