"""Where the time of one Llama train step goes on the card.

Runs the step ``mpi_operator_tpu_torch.bench`` times (``bench_single_chip()``,
AdamW with a bf16 first moment, seq 2048, batch 4 unless BENCH_SEQ and
BENCH_BATCH say otherwise) under ``torch.profiler`` for a few steps after
warm-up, and prints one JSON line: device time per step by kernel class
(the three flash kernels, matrix products, everything else), the top
kernels by device time, and the device's busy and idle share of the
profiled window.

    python -m mpi_operator_tpu_torch.profile_llama

Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from mpi_operator_tpu_torch import bench


def kernel_class(name: str) -> str:
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if f"{k}_kernel" in name:
            return k
    if any(s in name for s in ("gemm", "Gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
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


def main(steps: int = 3, warmup: int = 2) -> dict:
    seq_len = int(os.environ.get("BENCH_SEQ", "2048"))
    batch = int(os.environ.get("BENCH_BATCH", "4"))
    _, trainer, state, tokens, _ = bench.llama_setup(batch, seq_len, device="cuda")
    for _ in range(warmup):
        state, metrics = trainer.train_step(state, tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = trainer.train_step(state, tokens)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    by_class, by_name, intervals = defaultdict(float), defaultdict(float), []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_class[kernel_class(e.name)] += us
        by_name[e.name] += us
        intervals.append((e.time_range.start, e.time_range.end))
    busy = _busy_us(intervals)
    record = {
        "device": torch.cuda.get_device_name(0),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip(),
        "seq_len": seq_len,
        "batch": batch,
        "steps": steps,
        "loss": float(metrics["loss"]),
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us if kernels else None,
        "kernel_ms_per_step": {k: v / steps / 1e3 for k, v in sorted(by_class.items())},
        "top_kernels_ms_per_step": {
            n[:120]: v / steps / 1e3
            for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        },
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
