"""Where the time of a gang's Llama train steps goes, rank by rank.

``--gang N --out DIR`` reads a gang: the worker
(``workers/llama_worker.main``, the operator's entry point, configured by
the ``LLAMA_*`` environment) on N local ranks, one per card. Each rank
times its steps after the first 2 on the host's clock (synchronised at
both ends) and on its card (a CUDA event per step boundary), profiles its
last 2 steps (device time by kernel class: the three flash kernels, matrix
products, NCCL's collectives, everything else; the top kernels, the top
host operations, the device's busy and idle share), and writes
``rank<N>.json`` to DIR; the command prints one JSON line with every
rank's. It reads the ``tensor`` and ``sequence`` meshes that no benchmark
cell has; one card's step, and the gang's FSDP cell, are read by the
benchmark's traced runs (``python3 -m benchmark.run --workload <cell>
--seed 0 --seconds 10 --trace 1``).

    LLAMA_CONFIG=bench LLAMA_MESH=sequence=4 LLAMA_SEQ=16384 LLAMA_BATCH=1 LLAMA_STEPS=14 \
        python -m mpi_operator_tpu_torch.profile_llama --gang 4 --out DIR

Needs CUDA cards (``--device cpu`` for gloo ranks).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile


def kernel_class(name: str) -> str:
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if f"{k}_kernel" in name:
            return k
    if any(s in name for s in ("gemm", "Gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
    if "nccl" in name.lower():
        return "nccl"
    return "other"


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s >= end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(prof, wall_us: float, steps: int, classify=kernel_class) -> dict:
    """Per step of a profiled window of ``steps`` steps that took ``wall_us``
    on the host's clock: device time by kernel class (``classify`` maps a
    kernel's name to it), the top kernels, the device's busy time (the union
    of kernel intervals: the streams overlap) and idle share, and NCCL's
    share of the summed kernel time."""
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    by_class, by_name, intervals = defaultdict(float), defaultdict(float), []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_class[classify(e.name)] += us
        by_name[e.name] += us
        intervals.append((e.time_range.start, e.time_range.end))
    busy = _busy_us(intervals)
    total = sum(by_class.values())
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:12]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us if kernels else None,
        "kernel_ms_per_step": {k: v / steps / 1e3 for k, v in sorted(by_class.items())},
        "nccl_share_of_kernel_time": by_class["nccl"] / total if total else None,
        "top_kernels_ms_per_step": {
            n[:120]: v / steps / 1e3
            for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        },
        # where the host's time goes: each operation's own CPU time
        "top_host_ops_ms_per_step": {
            a.key[:120]: a.self_cpu_time_total / steps / 1e3 for a in host
        },
    }


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


WARM, PROFILED = 2, 2  # a gang rank's untimed first steps, and its profiled last ones


class _RankProbe:
    """``llama_worker.main``'s ``on_step`` hook on one rank of :func:`gang`:
    steps ``WARM`` to ``steps - PROFILED`` are timed, the last ``PROFILED``
    run under torch.profiler (outside the timed ones: the profiler's host
    cost would inflate them)."""

    def __init__(self, device: torch.device, steps: int):
        if steps <= WARM + PROFILED:
            raise ValueError(f"LLAMA_STEPS={steps}: a gang rank needs more than "
                             f"{WARM + PROFILED} steps")
        self.device, self.steps = device, steps
        self.marks = []  # (host seconds, CUDA event or None) at each timed step boundary
        self.prof = None
        self.prof_t0 = self.prof_t1 = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, i: int) -> None:
        last_timed = self.steps - PROFILED
        if i in (WARM, last_timed):
            self._sync()
        if WARM <= i <= last_timed:
            ev = None
            if self.device.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
            self.marks.append((time.perf_counter(), ev))
        if i == last_timed:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.prof_t0 = time.perf_counter()
        if i == self.steps:
            self._sync()
            self.prof_t1 = time.perf_counter()
            self.prof.stop()

    def summary(self) -> dict:
        (t0, _), (t1, _) = self.marks[0], self.marks[-1]
        n = len(self.marks) - 1
        device_ms = None
        if self.device.type == "cuda":
            device_ms = [a.elapsed_time(b) for (_, a), (_, b) in zip(self.marks, self.marks[1:])]
        return {"timed_steps": n, "step_ms": 1e3 * (t1 - t0) / n,
                "device_step_ms": device_ms,
                "profiled": summarize(self.prof, 1e6 * (self.prof_t1 - self.prof_t0), PROFILED)}


def _gang_rank(local_rank: int, device: str, environ: dict, out_dir: str) -> None:
    """One rank of :func:`gang`: the worker with a :class:`_RankProbe`."""
    os.environ.update(environ)
    from mpi_operator_tpu_torch.workers import llama_worker

    dev = torch.device("cuda", local_rank) if device == "cuda" else torch.device("cpu")
    probe = _RankProbe(dev, int(environ["LLAMA_STEPS"]))
    record = llama_worker.main(device=device, local_rank=local_rank, on_step=probe)
    out = {"rank": local_rank, "card": card() if device == "cuda" else "",
           **{k: record[k] for k in ("mesh", "losses", "kernel_launches")},
           **probe.summary()}
    with open(os.path.join(out_dir, f"rank{local_rank}.json"), "w") as f:
        json.dump(out, f)


def gang(ranks: int, environ: dict, out_dir: str, device: Optional[str] = None,
         timeout: Optional[float] = None) -> dict:
    """Run the worker on ``ranks`` local ranks (one host; ``environ`` holds
    its ``LLAMA_*`` settings, ``LLAMA_STEPS`` above 4), each read by a
    :class:`_RankProbe`; returns ``{"ranks": [rank 0's record, ...]}`` and
    leaves each in ``out_dir/rank<N>.json``. Raises ``RuntimeError`` when a
    rank fails."""
    from mpi_operator_tpu_torch.runtime import bootstrap

    dev = bootstrap.resolve_device(device)
    env = {**environ, bootstrap.ENV_NUM_HOSTS: "1", bootstrap.ENV_HOST_ID: "0",
           bootstrap.ENV_CHIPS_PER_HOST: str(ranks),
           bootstrap.ENV_COORDINATOR: f"127.0.0.1:{bootstrap.free_port()}"}
    os.makedirs(out_dir, exist_ok=True)
    codes = bootstrap.run_local_ranks(_gang_rank, ranks, (dev.type, env, str(out_dir)),
                                      timeout=timeout)
    if any(codes):
        raise RuntimeError(f"a rank of the gang failed: exit codes {codes}")
    ranks_out = []
    for r in range(ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks_out.append(json.load(f))
    return {"ranks": ranks_out}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gang", type=int, required=True, help="ranks of the worker to read")
    ap.add_argument("--out", required=True, help="the gang's per-rank records go here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    a = ap.parse_args()
    env = {k: v for k, v in os.environ.items() if k.startswith("LLAMA_")}
    print(json.dumps(gang(a.gang, env, a.out, a.device)), flush=True)
