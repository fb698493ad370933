"""One run of one cell: set-up, the window, the traced stretch, the check.

Set-up builds the program's training step once (the family's ``Session``)
and drives it through its first steps, whose readings the reference is held
to; the same object then runs the window, so nothing warms up or compiles
inside it. The window runs whole steps until ``seconds`` have passed and
ends with a synchronise. With ``trace``, ``torch.profiler`` then records the
cell's ``profile_steps`` more steps. Peak memory is read before the
program's state is freed, and the reference runs last.

A cell on several cards (``chips`` above 1) runs one process per card
(:func:`execute_ranks`, through the port's ``bootstrap.run_local_ranks``),
each joined to the gang and holding the cell's ``mesh``. Every rank runs
the same steps: the window ends where the first rank's clock says so. Each
rank reads every metric from its own steps and trace, and the line holds
the worst rank's reading of each (the largest where lower is better), the
largest peak memory, the busy seconds averaged over the ranks and the
breakdown of the rank whose card idled most.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from benchmark import readings, spec
from benchmark.trace import Trace

# top-level module names the run's process may not hold (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mpi_operator_tpu")


def cache_dirs(root: str) -> Dict[str, str]:
    """Fixed directories inside the checkout for every build and kernel cache
    (the kernel libraries through the port's compile cache), so that only a
    checkout's first run builds."""
    cache = os.path.join(root, "benchmark", ".cache")
    return {"TPUJOB_COMPILE_CACHE_DIR": os.path.join(cache, "kernels"),
            "TRITON_CACHE_DIR": os.path.join(cache, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(cache, "torch_extensions"),
            "CUDA_CACHE_PATH": os.path.join(cache, "cuda")}


def forbidden_modules(modules) -> List[str]:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gang() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _barrier(device) -> None:
    _sync(device)
    if _gang():
        dist.barrier()


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``): one rank's."""

    cell: spec.Cell
    device_kind: str
    unit: str  # what a step trains: "tokens" or "images"
    units_per_step: int  # over every chip
    setup_s: float
    steps: int  # the window's
    window_s: float
    memory_peak_bytes: Optional[int]  # None off the card
    input_wait_s: List[float]  # host seconds blocked on the input, per window step
    trace: Optional[Trace]
    root: str = spec.ROOT

    @property
    def chips(self) -> int:
        return self.cell.chips

    def peak(self, key: str) -> Optional[float]:
        return spec.peak(self.device_kind, key, self.root)

    def flops(self):
        """The family's FLOP counter (``flops/<family>.py``)."""
        import importlib

        return importlib.import_module(f"benchmark.flops.{spec.check_name(self.cell.family)}")


def _past(t0: float, seconds: float) -> bool:
    """Whether ``seconds`` have passed since ``t0``; in a gang, on any rank's
    clock (a CPU flag reduced over gloo), so that every rank stops together."""
    past = time.perf_counter() - t0 >= seconds
    if not _gang():
        return past
    flag = torch.tensor([int(past)], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def window(session, seconds: float, device):
    """Whole steps until ``seconds`` have passed; (steps, seconds to the
    synchronise after the last)."""
    _barrier(device)
    t0 = time.perf_counter()
    steps = 0
    while True:
        session.step()
        steps += 1
        if _past(t0, seconds):
            break
    _sync(device)
    return steps, time.perf_counter() - t0


def traced(session, steps: int, device) -> Trace:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _barrier(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            session.step()
        _sync(device)
        wall = time.perf_counter() - t0
    return Trace.from_profiler(prof, wall, steps)


def correctness(cell: spec.Cell, program: dict, seed: int, device):
    """(correct, checks): the reference's readings of the same steps, and
    the program's numbers beside the cell's limits. A gang's program names
    the parts of each leaf its ranks hold (``layouts``); the reference reads
    the same parts."""
    extra = {"layouts": program["layouts"]} if "layouts" in program else {}
    ref = spec.family(cell.family).reference(cell, seed, device, len(program["losses"]),
                                             **extra)
    return readings.judge(readings.compare(program, ref), cell.spec.get("limits", {}))


def _worst(values: List[float], better: str) -> float:
    return max(values) if better == "lower" else min(values)


def _over_ranks(local: Dict[str, Any], cell: spec.Cell) -> Dict[str, Any]:
    """Every rank's readings (``metrics``, ``device``, ``idle``, ``breakdown``)
    reduced to the gang's, on every rank."""
    ranks: List[Dict[str, Any]] = [None] * dist.get_world_size()  # type: ignore
    dist.all_gather_object(ranks, local)
    better = {m["name"]: m["better"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    for name in local["metrics"]:
        values = [r["metrics"][name]["value"] for r in ranks if name in r["metrics"]]
        metrics[name] = {"value": _worst(values, better[name]),
                         "unit": local["metrics"][name]["unit"]}
    dev = dict(local["device"])
    peaks = [r["device"]["memory_peak_bytes"] for r in ranks]
    dev["memory_peak_bytes"] = None if None in peaks else max(peaks)
    out = {"metrics": metrics, "device": dev, "breakdown": None,
           "forbidden": sorted({m for r in ranks for m in r["forbidden"]})}
    if local["breakdown"] is not None:
        dev["busy_s"] = sum(r["device"]["busy_s"] for r in ranks) / len(ranks)
        dev["window_s"] = max(r["device"]["window_s"] for r in ranks)
        out["breakdown"] = max(ranks, key=lambda r: r["idle"])["breakdown"]
    return out


def execute(name: str, seed: int, seconds: float, trace: bool, device: torch.device,
            t0: float, root: str = spec.ROOT, mesh=None) -> Tuple[Dict[str, Any], Dict]:
    """One run of cell ``name`` (in a gang, this rank's part, ``mesh`` the
    cell's): (the result line as a dict, ``checks`` last; the seconds of
    set-up's parts and of the reference, and the top-level modules that
    may not be held). ``t0`` is the process's start on
    ``time.perf_counter``."""
    cell = spec.load_cell(name, root)
    fam = spec.family(cell.family)
    marks = {"start": time.perf_counter() - t0}
    session = fam.Session(cell, seed, device, mesh=mesh)
    _sync(device)
    marks["built"] = time.perf_counter() - t0
    program = session.first_steps(int(cell.spec["reference_steps"]))
    _barrier(device)
    setup_s = time.perf_counter() - t0
    marks["first_steps"] = setup_s
    steps, window_s = window(session, seconds, device)
    waits = list(session.input_wait_s)
    tr = traced(session, int(cell.spec["profile_steps"]), device) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = Run(cell, kind, session.unit, session.units_per_step, setup_s, steps, window_s,
              peak, waits, tr, root)
    session.close()
    del session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    correct, checks = correctness(cell, program, seed, device)
    marks["reference"] = time.perf_counter() - t_ref

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    if tr is not None:
        dev.update(busy_s=tr.busy_s(), window_s=tr.wall_s)
        breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    forbidden = forbidden_modules(sys.modules)
    if _gang():
        idle = 1.0 - tr.busy_s() / tr.wall_s if tr is not None else 0.0
        gang = _over_ranks({"metrics": metrics, "device": dev, "breakdown": breakdown,
                            "idle": idle, "forbidden": forbidden}, cell)
        metrics, dev, breakdown, forbidden = (gang["metrics"], gang["device"],
                                              gang["breakdown"], gang["forbidden"])
    out: Dict[str, Any] = {"correct": correct, "attempted": steps, "failed": 0,
                           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out, {"seconds": marks, "forbidden": forbidden}


def _rank(local_rank: int, chips: int, port: int, device_type: str, result: str, job,
          mesh_spec: str, args: tuple) -> None:
    """One rank of :func:`in_gang`: join the gang, build the mesh, run
    ``job`` and (rank 0) write what it returns to the file ``result``."""
    from mpi_operator_tpu_torch.runtime import bootstrap, topology

    ctx = bootstrap.RuntimeContext(chips_per_host=chips, coordinator_address=f"127.0.0.1:{port}")
    device = bootstrap.initialize(ctx, device=device_type, local_rank=local_rank, group=True)
    try:
        mesh = topology.mesh_from_context(ctx, topology.MeshPlan.parse(mesh_spec), device.type)
        value = job(device, mesh, *args)
        if dist.get_rank() == 0:
            with open(result, "w") as f:
                json.dump(value, f)
    finally:
        bootstrap.shutdown()


def in_gang(job, cell: spec.Cell, args: tuple, device_type: str = "cuda",
            timeout: float = 330.0):
    """``job(device, mesh, *args)`` in one process per card of ``cell``, each
    a rank of one gang on this host over the cell's mesh; returns what rank
    0's returned (through JSON). Raises ``RuntimeError`` where a rank fails
    or outlasts ``timeout`` (every rank has ended by then)."""
    from mpi_operator_tpu_torch.runtime import bootstrap

    fd, result = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        codes = bootstrap.run_local_ranks(
            _rank, cell.chips, (cell.chips, bootstrap.free_port(), device_type, result, job,
                                cell.mesh, args), timeout=timeout)
        if any(codes):
            raise RuntimeError(f"the ranks of {cell.name} exited with {codes}")
        with open(result) as f:
            return json.load(f)
    finally:
        os.unlink(result)


def _execute_job(device, mesh, name, seed, seconds, trace, t0, root, fault):
    import contextlib

    if fault:
        from benchmark import faults

        planted = faults.planted(fault)
    else:
        planted = contextlib.nullcontext()
    with planted:
        return execute(name, seed, seconds, trace, device, t0, root, mesh=mesh)


def execute_ranks(name: str, seed: int, seconds: float, trace: bool, t0: float,
                  root: str = spec.ROOT, device_type: str = "cuda",
                  fault: str = "") -> Tuple[Dict[str, Any], Dict]:
    """:func:`execute` of a cell on several cards, one rank per card; the
    result holds the gang's readings. ``fault`` plants one of
    ``benchmark.faults`` in every rank (the tests' and calibration's, never
    the command's)."""
    out, extra = in_gang(_execute_job, spec.load_cell(name, root),
                         (name, seed, seconds, trace, t0, root, fault), device_type)
    return out, extra
