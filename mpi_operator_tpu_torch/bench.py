"""Llama training throughput on one CUDA device.

Port of the Llama mode of the repository's ``bench.py`` (``llama_setup``,
``_timed_steps``, ``bench_llama``): ``bench_single_chip()`` trained with
AdamW and the hand-written flash kernels, reporting tokens/s, step time and
MFU against the card's dense bf16 peak. Before timing it checks K1 against
its plain version at the JAX bench's gate shape.

    python -m mpi_operator_tpu_torch.bench

Knobs (as in the JAX bench): BENCH_SEQ (2048), BENCH_BATCH (per-device
batch; 10 with bf16 first moments, else 8), BENCH_STEPS (20), BENCH_WARMUP
(3), BENCH_MU_BF16 (1). Prints one JSON line. Runs on CUDA only: there is
no CPU fallback, and without a card it raises.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Union

import torch

# dense (no sparsity) bf16 tensor-core peak per device, by name prefix
# (NVIDIA data sheets; SXM parts at their full power limit)
PEAK_BF16_FLOPS = {
    "NVIDIA H100": 989e12,
    "NVIDIA H200": 989e12,
}
TARGET_MFU = 0.50


def peak_flops(device_name: str) -> float:
    for prefix, peak in PEAK_BF16_FLOPS.items():
        if device_name.startswith(prefix):
            return peak
    raise ValueError(f"no bf16 peak recorded for {device_name!r}")


def _mu_bf16() -> bool:
    return os.environ.get("BENCH_MU_BF16", "1") != "0"


def llama_per_chip_batch() -> int:
    return int(os.environ.get("BENCH_BATCH", "10" if _mu_bf16() else "8"))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def llama_setup(
    per_chip_batch: int,
    seq_len: int,
    *,
    config=None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
):
    """Build the bench workload. Returns (cfg, trainer, state, batch,
    global_batch). ``config`` defaults to ``bench_single_chip()`` (the
    long-context config above 8k tokens)."""
    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
    from mpi_operator_tpu_torch.runtime.bootstrap import initialize

    device = initialize(device=device)
    if config is None:
        config = llama.bench_long_context() if seq_len > 8192 else llama.bench_single_chip()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = llama.init(config, gen, device)
    trainer = Trainer(
        llama.loss_fn,
        TrainerConfig(
            learning_rate=3e-4, optimizer="adamw", grad_clip_norm=1.0,
            adam_mu_bf16=_mu_bf16(),
        ),
    )
    state = trainer.init_state(model)
    global_batch = per_chip_batch  # one device
    batch = make_global_batch(
        next(synthetic_tokens(global_batch=global_batch, seq_len=seq_len, vocab=config.vocab)),
        device,
    )
    return config, trainer, state, batch, global_batch


def timed_steps(trainer, state, batch, steps: int, warmup: int, *, on_step=None):
    """Time ``steps`` train steps after ``warmup`` untimed ones (at least
    one). The first call is timed apart as set-up (kernel build, allocator
    and cuBLAS warm-up). ``on_step(metrics)`` sees every step's metrics,
    after the timed window for the timed ones. Returns (state, seconds,
    steps, setup_s, warmup_s)."""
    device = batch["tokens"].device
    t0 = time.perf_counter()
    state, metrics = trainer.train_step(state, batch)
    _sync(device)
    setup_s = time.perf_counter() - t0
    if on_step:
        on_step(metrics)
    t0 = time.perf_counter()
    for _ in range(warmup - 1):
        state, metrics = trainer.train_step(state, batch)
        if on_step:
            on_step(metrics)
    _sync(device)
    warmup_s = time.perf_counter() - t0
    timed = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
        timed.append(metrics)
    _sync(device)
    dt = time.perf_counter() - t0
    if on_step:
        for m in timed:
            on_step(m)
    return state, dt, steps, setup_s, warmup_s


def check_flash_kernel(device: Union[str, torch.device] = "cuda", seed: int = 7) -> float:
    """K1 (through ``flash_attention``) against its plain version at the JAX
    bench's gate shape (B2, T512, H8, Hkv4, D64, bf16, causal). Returns the
    max abs error; raises above 0.05."""
    from mpi_operator_tpu_torch.kernels.flash_attention import (
        flash_attention,
        flash_fwd_plain,
    )

    gen = torch.Generator(device=device).manual_seed(seed)
    b, t, h, h_kv, d = 2, 512, 8, 4, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    q, k, v = rnd(b, t, h, d), rnd(b, t, h_kv, d), rnd(b, t, h_kv, d)
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=True)
        ref, _ = flash_fwd_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True, d ** -0.5
        )
    err = float((out.float() - ref.transpose(1, 2).float()).abs().max())
    print(f"[bench] flash kernel check: max abs err {err:.5f}", file=sys.stderr)
    if err > 0.05:
        raise AssertionError(f"flash kernel mismatch on device: {err}")
    return err


def bench_llama(*, seq_len=None, per_chip_batch=None, steps=None, warmup=None, device=None):
    """Run the benchmark and print its JSON line; returns the record. Each
    argument left None is read from its BENCH_* knob. The record holds every
    step's loss and the kernel launches of the training run (the K1 check
    before it is not counted)."""
    from mpi_operator_tpu_torch.kernels import flash_attention as fa
    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.runtime.bootstrap import initialize

    device = initialize(device=device)
    if device.type != "cuda":
        raise RuntimeError("the benchmark measures the card; it does not run on the CPU")
    kind = torch.cuda.get_device_name(device)
    peak = peak_flops(kind)
    flash_err = check_flash_kernel(device)
    if per_chip_batch is None:
        per_chip_batch = llama_per_chip_batch()
    if seq_len is None:
        seq_len = int(os.environ.get("BENCH_SEQ", "2048"))
    if steps is None:
        steps = int(os.environ.get("BENCH_STEPS", "20"))
    if warmup is None:
        warmup = int(os.environ.get("BENCH_WARMUP", "3"))
    warmup = max(1, warmup)

    cfg, trainer, state, batch, global_batch = llama_setup(
        per_chip_batch, seq_len, device=device
    )
    torch.cuda.reset_peak_memory_stats(device)
    losses = []
    fa.reset_launches()
    state, dt, steps, setup_s, warmup_s = timed_steps(
        trainer, state, batch, steps, warmup, on_step=lambda m: losses.append(float(m["loss"]))
    )
    per_chip = global_batch * seq_len * steps / dt
    mfu = 3 * llama.flops_per_token(cfg, seq_len) * per_chip / peak
    record = {
        "metric": "llama_train_throughput_per_chip",
        "value": per_chip,
        "unit": "tokens/sec/chip",
        "vs_baseline": mfu / TARGET_MFU,
        "chips": 1,
        "device": kind,
        "params": llama.param_count(cfg),
        "global_batch": global_batch,
        "seq_len": seq_len,
        "matmul_precision": cfg.matmul_precision,
        "mfu": mfu,
        "step_ms": 1000 * dt / steps,
        "setup_s": setup_s,
        "warmup_s": warmup_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device),
        "flash_kernel_max_err": flash_err,
        "kernel_launches": dict(fa.launches),
        "losses": losses,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    bench_llama()
