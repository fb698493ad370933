"""Training throughput on one CUDA device: Llama, long-context Llama and
ResNet-101.

Port of the repository's ``bench.py``. ``BENCH_MODEL`` picks the workload:

- ``llama``: ``bench_single_chip()`` trained with AdamW and the
  hand-written flash kernels, reporting tokens/s, step time and MFU
  against the card's dense bf16 peak; before timing it checks K1 against
  its plain version at the JAX bench's gate shape. Knobs: BENCH_SEQ
  (2048), BENCH_BATCH (per-device batch; 10 with bf16 first moments, else
  8), BENCH_STEPS (20), BENCH_WARMUP (3), BENCH_MU_BF16 (1), BENCH_QUANT
  (bf16 | int8 | fp8: the FFN products, kernels/quant_matmul);
- ``llama-long``: the same at BENCH_SEQ_LONG (16384) and BENCH_BATCH_LONG
  (1) on ``bench_long_context()``;
- ``resnet``: ResNet-101 at 224 px trained with momentum SGD (lr 0.1, no
  clipping), the twin of the reference's tf_cnn_benchmarks line (154.2
  images/s per GPU). Knobs: BENCH_BATCH (128), BENCH_STEPS (30),
  BENCH_WARMUP (5), BENCH_INPUT (stream: uint8 batches through
  ``ops.data.prefetch`` with the normalize on the card; fixed: one resident
  batch), BENCH_PREFETCH_DEPTH (2), BENCH_STEPS_PER_CALL (10),
  BENCH_RESNET_DEPTH, BENCH_IMAGE_SIZE;
- ``all`` (the default): the three in that order, ResNet last, as the JAX
  bench runs them.

    python -m mpi_operator_tpu_torch.bench

Prints one JSON line per workload. Runs on CUDA only: there is no CPU
fallback, and without a card it raises.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from typing import Optional, Union

import torch

# dense (no sparsity) bf16 tensor-core peak per device, by name prefix
# (NVIDIA data sheets; SXM parts at their full power limit)
PEAK_BF16_FLOPS = {
    "NVIDIA H100": 989e12,
    "NVIDIA H200": 989e12,
}
TARGET_MFU = 0.50
BASELINE_IMG_PER_SEC_PER_DEVICE = 154.2  # the reference's ResNet-101 line


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
    quant: Optional[str] = None,
):
    """Build the bench workload. Returns (cfg, trainer, state, batch,
    global_batch). ``config`` defaults to ``bench_single_chip()`` (the
    long-context config above 8k tokens); ``quant`` (default: BENCH_QUANT,
    else bf16) sets its ``matmul_precision``."""
    import dataclasses

    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
    from mpi_operator_tpu_torch.runtime.bootstrap import initialize

    device = initialize(device=device)
    if config is None:
        config = llama.bench_long_context() if seq_len > 8192 else llama.bench_single_chip()
    quant = quant or os.environ.get("BENCH_QUANT", "bf16")
    if quant != "bf16":
        config = dataclasses.replace(config, matmul_precision=quant)
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


def timed_steps(trainer, state, batch, steps: int, warmup: int, *, on_step=None,
                steps_per_call: int = 1, batches=None):
    """Time ``steps`` train steps after ``warmup`` untimed ones (at least
    one). The first call is timed apart as set-up (kernel build, allocator
    and cuBLAS warm-up). ``on_step(metrics)`` sees every call's metrics,
    after the timed window for the timed ones. ``steps_per_call`` > 1 runs
    each call as ``trainer.multi_step`` (the JAX bench's steps per
    dispatch); ``batches`` (an iterator, such as ``ops.data.prefetch``)
    gives every call a fresh batch, so the timed window pays whatever input
    cost the pipeline does not hide. Returns (state, seconds, steps,
    setup_s, warmup_s)."""
    def run(state):
        b = next(batches) if batches is not None else batch
        if steps_per_call == 1:
            return trainer.train_step(state, b)
        return trainer.multi_step(state, b, steps_per_call)

    device = next(state.params.parameters()).device
    t0 = time.perf_counter()
    state, metrics = run(state)
    _sync(device)
    setup_s = time.perf_counter() - t0
    if on_step:
        on_step(metrics)
    t0 = time.perf_counter()
    for _ in range(warmup - 1):
        state, metrics = run(state)
        if on_step:
            on_step(metrics)
    _sync(device)
    warmup_s = time.perf_counter() - t0
    calls = max(1, steps // steps_per_call)
    timed = []
    t0 = time.perf_counter()
    for _ in range(calls):
        state, metrics = run(state)
        timed.append(metrics)
    _sync(device)
    dt = time.perf_counter() - t0
    if on_step:
        for m in timed:
            on_step(m)
    return state, dt, calls * steps_per_call, setup_s, warmup_s


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


def _card(device) -> torch.device:
    from mpi_operator_tpu_torch.runtime.bootstrap import initialize

    device = initialize(device=device)
    if device.type != "cuda":
        raise RuntimeError("the benchmark measures the card; it does not run on the CPU")
    return device


def bench_llama(*, seq_len=None, per_chip_batch=None, steps=None, warmup=None, device=None,
                metric="llama_train_throughput_per_chip", check_kernel=True, quant=None):
    """Run the benchmark and print its JSON line; returns the record. Each
    argument left None is read from its BENCH_* knob. The record holds every
    step's loss and the kernel launches of the training run (the K1 check
    before it is not counted): the flash kernels' and, at int8 or fp8, the
    quantized products'."""
    from mpi_operator_tpu_torch.kernels import flash_attention as fa
    from mpi_operator_tpu_torch.kernels import quant_matmul as qm
    from mpi_operator_tpu_torch.models import llama

    device = _card(device)
    kind = torch.cuda.get_device_name(device)
    peak = peak_flops(kind)
    flash_err = check_flash_kernel(device) if check_kernel else None
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
        per_chip_batch, seq_len, device=device, quant=quant
    )
    torch.cuda.reset_peak_memory_stats(device)
    losses = []
    fa.reset_launches()
    qm.reset_launches()
    state, dt, steps, setup_s, warmup_s = timed_steps(
        trainer, state, batch, steps, warmup, on_step=lambda m: losses.append(float(m["loss"]))
    )
    per_chip = global_batch * seq_len * steps / dt
    mfu = 3 * llama.flops_per_token(cfg, seq_len) * per_chip / peak
    record = {
        "metric": metric,
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
        "quant_launches": dict(qm.launches),
        "losses": losses,
    }
    print(json.dumps(record), flush=True)
    return record


def bench_llama_longctx(device=None):
    """The long-context line: the Llama at BENCH_SEQ_LONG (16384) and
    BENCH_BATCH_LONG (1) per card on ``bench_long_context()``. Its mfu counts
    full-T attention FLOPs, as the JAX bench's does (the causal kernels do
    half that work): compare tokens/s across runs, not this mfu."""
    return bench_llama(
        seq_len=int(os.environ.get("BENCH_SEQ_LONG", "16384")),
        per_chip_batch=int(os.environ.get("BENCH_BATCH_LONG", "1")),
        metric="llama_longctx_train_throughput_per_chip",
        check_kernel=False,  # the 2k line checked it
        device=device,
    )


def bench_resnet(*, warmup=None, input_mode=None, device=None):
    """ResNet training throughput (the JAX bench's ``bench_resnet``); prints
    and returns its JSON record. Its knobs are the BENCH_* environment
    (module docstring); ``warmup`` and ``input_mode`` left None are read
    from BENCH_WARMUP and BENCH_INPUT."""
    from mpi_operator_tpu_torch.models import resnet
    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.data import (
        imagenet_normalize,
        make_global_batch,
        prefetch,
        synthetic_imagenet,
    )

    env = os.environ
    device = _card(device)
    kind = torch.cuda.get_device_name(device)
    peak = peak_flops(kind)
    per_chip_batch = int(env.get("BENCH_BATCH", "128"))
    steps = int(env.get("BENCH_STEPS", "30"))
    warmup = max(1, warmup or int(env.get("BENCH_WARMUP", "5")))
    input_mode = input_mode or env.get("BENCH_INPUT", "stream")
    steps_per_call = int(env.get("BENCH_STEPS_PER_CALL", "10"))
    prefetch_depth = int(env.get("BENCH_PREFETCH_DEPTH", "2"))
    cfg = resnet.Config(depth=env.get("BENCH_RESNET_DEPTH", "resnet101"),
                        image_size=int(env.get("BENCH_IMAGE_SIZE", "224")))
    global_batch = per_chip_batch  # one device

    model = resnet.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    trainer = Trainer(resnet.loss_fn, TrainerConfig(learning_rate=0.1, optimizer="momentum",
                                                    grad_clip_norm=0.0))
    state = trainer.init_state(model)
    batch = batches = None
    if input_mode == "stream":
        batches = prefetch(
            synthetic_imagenet(global_batch=global_batch, image_size=cfg.image_size,
                               dtype="uint8"),
            device, depth=prefetch_depth, device_transform=imagenet_normalize())
    elif input_mode == "fixed":
        batch = make_global_batch(
            next(synthetic_imagenet(global_batch=global_batch, image_size=cfg.image_size)),
            device)
    else:
        raise ValueError(f"BENCH_INPUT={input_mode!r}; expected stream|fixed")

    torch.cuda.reset_peak_memory_stats(device)
    losses = []
    try:
        state, dt, steps, setup_s, warmup_s = timed_steps(
            trainer, state, batch, steps, warmup, steps_per_call=steps_per_call,
            batches=batches, on_step=lambda m: losses.append(float(m["loss"])))
    finally:
        if batches is not None:
            batches.close()  # release the prefetch producer and its buffers
    per_chip = global_batch * steps / dt
    mfu = 3 * resnet.flops_per_sample(cfg) * per_chip / peak
    record = {
        "metric": "resnet101_train_throughput_per_chip",
        "value": per_chip,
        "unit": "images/sec/chip",
        "vs_baseline": per_chip / BASELINE_IMG_PER_SEC_PER_DEVICE,
        "chips": 1,
        "device": kind,
        "model": cfg.depth,
        "image_size": cfg.image_size,
        "global_batch": global_batch,
        "input": input_mode,
        "prefetch_depth": prefetch_depth if input_mode == "stream" else None,
        "steps_per_call": steps_per_call,
        "mfu": mfu,
        "step_ms": 1000 * dt / steps,
        "setup_s": setup_s,
        "warmup_s": warmup_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device),
        "losses": losses,
    }
    print(json.dumps(record), flush=True)
    return record


def main() -> None:
    mode = os.environ.get("BENCH_MODEL", "all")
    runs = {"llama": [bench_llama], "llama-long": [bench_llama_longctx],
            "resnet": [bench_resnet],
            # ResNet last, so its line stays the parsed headline (the JAX bench's order)
            "all": [bench_llama, bench_llama_longctx, bench_resnet]}
    if mode not in runs:
        raise SystemExit(f"unknown BENCH_MODEL={mode!r} (llama|llama-long|resnet|all)")
    for run in runs[mode]:
        run()
        gc.collect()  # drop the workload's tensors before the next one
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
