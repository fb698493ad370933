"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the hand-written kernels from ``mpi_operator_tpu_torch/kernels/csrc``
   with nvcc, one process per source, all at once;
3. kernels: K1 (forward), K2 (dq) and K3 (dk/dv), then the autograd path,
   each against its plain PyTorch version on the same inputs, bf16, causal
   and not, at the JAX bench's gate shape, the Llama model's shape and a
   ragged T. Ceilings: o 3e-2 abs, lse 1e-3 abs, dq/dk/dv 3e-2 x max|ref|;
   beside them every row (a query of o/dq, a key of dk/dv) is held to
   TOL_ROW relative to its own RMS, so late causal keys and queries, whose
   values are far below the tensor's max, are held too. At the model shape
   the smoke also shows that this check rejects a result whose last quarter
   of T is zero. Then each kernel, its plain version and PyTorch's
   ``scaled_dot_product_attention`` (the yardstick, never on the port's
   path) timed with CUDA events at the model shape, with each kernel's
   TFLOP/s and share of its bound; SDPA's backward alone (dq, dk and dv in
   one call) is the yardstick of the K2 + K3 pair;
4. reference: a small Llama (head_dim 64, so the kernels take it) on the
   card against the same weights on the CPU, where the plain versions run:
   loss and gradient norm agree;
5. main path: ``bench_single_chip()`` (~0.79B params) at seq 2048, batch 4,
   AdamW, through the benchmark entry point ``bench.bench_llama`` (its K1
   check, then 2 warm-up and 5 timed steps). Every loss is finite, the
   first and last are the recorded ones (10.9078 and 0.1252 to the printed digits: the
   batch is fixed), and each kernel launches once per layer per step (84
   in 7 steps): the per-layer remat saves K1's outputs instead of running
   K1 again;
6. gang path: the worker as the operator runs it
   (``python -m mpi_operator_tpu_torch.workers.llama_worker``, one process
   per incarnation), ``bench_single_chip()`` at seq 2048, batch 4, on a
   one-rank NCCL group with ``LLAMA_MESH=fsdp=1`` (FSDP2's DTensor
   parameters around the kernels): (a) 4 steps, no checkpoint; (b) elastic,
   a hostfile of 2 hosts: saves at step 2 and exits 75; (c) the same
   checkpoint dir, a hostfile of 1 host: restores step 2, runs to 4 and
   exits 0. (b)'s and (c)'s losses equal (a)'s within 1e-6 relative; their
   step-stats blobs have compute and ckpt seconds; the checkpoint's bytes,
   save and restore times are printed. The checkpoint (~9.5 GB) goes to a
   temporary directory in ``$TMPDIR`` or the checkout, whichever has more
   room; under 3 checkpoints of room the phase fails.

The line before the last is a JSON object with one entry per kernel (its
registers and spill bytes per head dim from ptxas beside its numbers); the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, same source
CU_SOURCE = "mpi_operator_tpu_torch/kernels/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "mpi_operator_tpu/kernels/flash_attention.py:172",
    "flash_bwd_dq": "mpi_operator_tpu/kernels/flash_attention.py:347",
    "flash_bwd_dkv": "mpi_operator_tpu/kernels/flash_attention.py:370",
}
CUDA_KERNEL = {  # wrapper -> its __global__ function in CU_SOURCE
    "flash_fwd": "flash_fwd_kernel",
    "flash_bwd_dq": "flash_bwd_dq_kernel",
    "flash_bwd_dkv": "flash_bwd_dkv_kernel",
}
# the main path's first and last losses as recorded in PERF.md, to the printed digits
MAIN_FIRST_LOSS, MAIN_LAST_LOSS = 10.9078, 0.1252
MODEL_SHAPE = (4, 2048, 16, 4, 128)  # B, T, H, Hkv, D of bench_single_chip at seq 2048
SHAPES = [
    ("gate", (2, 512, 8, 4, 64)),
    ("model", MODEL_SHAPE),
    ("ragged", (1, 1000, 8, 2, 128)),
]
# ceilings on the max abs error: o, lse, and dq/dk/dv as a share of max|ref|
TOL_O, TOL_LSE, TOL_GRAD_REL = 3e-2, 1e-3, 3e-2
# the tight check beside them: worst per-row relative RMS error (_row_err)
TOL_ROW, ROW_FLOOR = 1e-2, 0.1


def _grad_bound(ref) -> float:
    return TOL_GRAD_REL * float(ref.float().abs().max())


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return smi


def phase_build() -> dict:
    """Build every library; returns, per wrapper, ptxas's registers and
    spill bytes (stores + loads) of its kernel at each head dim."""
    from mpi_operator_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    per_lib = _build.build()
    log(f"[build] {time.perf_counter() - t0:.1f}s "
        + ", ".join(f"{k} {v:.1f}s" for k, v in per_lib.items()))
    res = {}
    for name in _build.SOURCES:
        res.update(_build.kernel_resources(_build.build_log(name), CUDA_KERNEL.values()))
    out = {}
    for wrapper, kernel in CUDA_KERNEL.items():
        regs, spills = {}, {}
        for d in (64, 128):
            r = res.get(f"{kernel}<{d}>")
            if r is None:
                fail(f"ptxas reported nothing for {kernel}<{d}>")
            regs[str(d)] = r["registers"]
            spills[str(d)] = r["spill_stores"] + r["spill_loads"]
        log(f"[build] {kernel}: registers {regs}, spill bytes {spills} (D64/D128)")
        out[wrapper] = {"registers": regs, "spill_bytes": spills}
    return out


def _inputs(shape, seed: int):
    b, t, h, h_kv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)

    return rnd(b, h, t, d), rnd(b, h_kv, t, d), rnd(b, h_kv, t, d), rnd(b, h, t, d)


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _row_err(got, ref) -> float:
    """Worst per-row error: over every row of the last axis (one query of o
    and dq, one key of dk and dv), the RMS of got - ref over the RMS of the
    reference row, floored at ROW_FLOOR x the tensor's RMS so that rows
    near zero are held in absolute terms."""
    g = got.float().reshape(-1, got.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    floor = ROW_FLOOR * float(r.pow(2).mean().sqrt())
    row_rms = r.pow(2).mean(-1).sqrt().clamp_min(floor)
    return float(((g - r).pow(2).mean(-1).sqrt() / row_rms).max())


def _check(name: str, got, ref, bound: float) -> float:
    """Max abs error within ``bound`` (the ceiling) and per-row error within
    TOL_ROW. Returns the max abs error."""
    err, row = _max_err(got, ref), _row_err(got, ref)
    log(f"[kernels] {name}: max abs err {err:.3e} (bound {bound:.3e}), "
        f"row err {row:.3e} (bound {TOL_ROW:.1e})")
    if not err <= bound:  # also catches NaN
        fail(f"{name} disagrees with its plain version: {err} > {bound}")
    if not row <= TOL_ROW:
        fail(f"{name} disagrees with its plain version row by row: {row} > {TOL_ROW}")
    return err


def _check_has_power(name: str, ref) -> None:
    """The per-row check must reject a result whose last quarter of rows on
    the T axis (late keys for dk/dv, late queries for o/dq) are zero."""
    bad = ref.clone()
    bad[..., -(ref.shape[-2] // 4):, :] = 0
    row = _row_err(bad, ref)
    log(f"[kernels] {name} with the last quarter of T zeroed: row err {row:.3e}")
    if not row > TOL_ROW:
        fail(f"the per-row check would pass {name} with its last quarter of T zeroed")


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the worst abs error
    per kernel at the model shape."""
    from mpi_operator_tpu_torch.kernels import flash_attention as fa

    errs = {}
    for i, (label, shape) in enumerate(SHAPES):
        for causal in (True, False):
            q, k, v, do = _inputs(shape, seed=2 * i + causal)
            scale = shape[4] ** -0.5
            tag = f"{label} {'causal' if causal else 'full'} {shape}"
            with torch.no_grad():
                o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale)
                o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
                torch.cuda.synchronize()
                e_o = _check(f"K1 o {tag}", o, o_ref, TOL_O)
                e_lse = _max_err(lse, lse_ref)
                log(f"[kernels] K1 lse {tag}: max abs err {e_lse:.3e} (bound {TOL_LSE:.1e})")
                if not e_lse <= TOL_LSE:
                    fail(f"K1 lse {tag} disagrees with its plain version: {e_lse}")
                delta = (do.float() * o_ref.float()).sum(-1)
                args = (q, k, v, do, lse_ref, delta, causal, scale)
                dq_ref = fa.flash_bwd_dq_plain(*args)
                dq = fa.flash_bwd_dq_cuda(*args)
                torch.cuda.synchronize()
                e_dq = _check(f"K2 dq {tag}", dq, dq_ref, _grad_bound(dq_ref))
                dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*args)
                dk, dv = fa.flash_bwd_dkv_cuda(*args)
                torch.cuda.synchronize()
                e_dk = _check(f"K3 dk {tag}", dk, dk_ref, _grad_bound(dk_ref))
                e_dv = _check(f"K3 dv {tag}", dv, dv_ref, _grad_bound(dv_ref))
                if label == "model" and causal:
                    for name, ref in (("o", o_ref), ("dq", dq_ref), ("dk", dk_ref),
                                      ("dv", dv_ref)):
                        _check_has_power(f"{name} {tag}", ref)
            # the autograd path: flash_attention forward + backward
            qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
            out = fa.flash_attention(qg, kg, vg, causal=causal, scale=scale, layout="bhtd")
            grads = torch.autograd.grad(out, (qg, kg, vg), do)
            torch.cuda.synchronize()
            with torch.no_grad():
                _check(f"autograd o {tag}", out, o_ref, TOL_O)
                for gname, got, ref in zip(("dq", "dk", "dv"), grads, (dq_ref, dk_ref, dv_ref)):
                    _check(f"autograd {gname} {tag}", got, ref, _grad_bound(ref))
            if label == "model" and causal:
                errs = {
                    "flash_fwd": max(e_o, e_lse),
                    "flash_bwd_dq": e_dq,
                    "flash_bwd_dkv": max(e_dk, e_dv),
                }
            del q, k, v, do, o_ref, lse_ref, dq_ref, dk_ref, dv_ref, qg, kg, vg, out, grads
            torch.cuda.empty_cache()
    return errs


def _time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(shape, n_matmuls: int, in_bytes: int, out_bytes: int):
    """(least time in ms, what bounds it, FLOP) for the work of one launch at
    ``shape``, causal: the larger of bytes over HBM rate and tensor-core FLOP
    over the bf16 peak. FLOP counts the causal triangle T(T+1)/2 of (q, k)
    pairs."""
    b, t, h, _, d = shape
    flops = 2 * n_matmuls * b * h * d * t * (t + 1) / 2
    bytes_ms = 1e3 * (in_bytes + out_bytes) / HBM_BYTES_PER_S
    flops_ms = 1e3 * flops / BF16_FLOPS_PER_S
    if flops_ms >= bytes_ms:
        return flops_ms, "operations", flops
    return bytes_ms, "bytes", flops


def phase_timing(smi: str) -> dict:
    """Times (ms) of each kernel, its plain version and the SDPA yardstick at
    the model shape, causal."""
    from mpi_operator_tpu_torch.kernels import flash_attention as fa

    b, t, h, h_kv, d = MODEL_SHAPE
    scale = d ** -0.5
    q, k, v, do = _inputs(MODEL_SHAPE, seed=11)
    with torch.no_grad():
        o, lse = fa.flash_fwd_cuda(q, k, v, True, scale)
        delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale)
    n_q, n_kv = q.numel() * 2, k.numel() * 2  # bf16 bytes
    n_row = b * h * t * 4  # one f32 per (b, h, t)
    out = {}
    with torch.no_grad():
        k_x = k.repeat_interleave(h // h_kv, dim=1)  # SDPA's MHA form of the same K/V
        v_x = v.repeat_interleave(h // h_kv, dim=1)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa_fwd = _time_ms(lambda: sdpa(q, k_x, v_x, is_causal=True, scale=scale))
        specs = {
            "flash_fwd": (
                lambda: fa.flash_fwd_cuda(q, k, v, True, scale),
                lambda: fa.flash_fwd_plain(q, k, v, True, scale),
                _bound(MODEL_SHAPE, 2, n_q + 2 * n_kv, n_q + n_row), sdpa_fwd,
            ),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq_cuda(*args),
                lambda: fa.flash_bwd_dq_plain(*args),
                _bound(MODEL_SHAPE, 3, 2 * n_q + 2 * n_kv + 2 * n_row, n_q), None,
            ),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv_cuda(*args),
                lambda: fa.flash_bwd_dkv_plain(*args),
                _bound(MODEL_SHAPE, 4, 2 * n_q + 2 * n_kv + 2 * n_row, 2 * n_kv), None,
            ),
        }
        for name, (kernel, plain, (bound_ms, bound_by, flops), lib_ms) in specs.items():
            ms = _time_ms(kernel)
            plain_ms = _time_ms(plain, reps=2)
            tflops = flops / (ms * 1e-3) / 1e12
            out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=lib_ms, tflops=tflops, bound_share=bound_ms / ms)
            log(f"[timing] {name} {MODEL_SHAPE} causal: kernel {ms:.4f} ms "
                f"({tflops:.1f} TFLOP/s, {100 * bound_ms / ms:.1f} % of bound), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), sdpa "
                f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} [{smi}]")
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k_x, v_x))
    # SDPA's backward alone: its forward runs once, outside the timed window
    o_sdpa = sdpa(qg, kg, vg, is_causal=True, scale=scale)
    sdpa_bwd = _time_ms(lambda: torch.autograd.grad(o_sdpa, (qg, kg, vg), do, retain_graph=True))
    del o_sdpa
    dq_ms, dkv_ms = out["flash_bwd_dq"]["ms"], out["flash_bwd_dkv"]["ms"]
    log(f"[timing] bwd {MODEL_SHAPE} causal: K2 + K3 {dq_ms + dkv_ms:.4f} ms (K2 {dq_ms:.4f}, "
        f"K3 {dkv_ms:.4f}), sdpa backward alone {sdpa_bwd:.4f} ms (dq, dk, dv of the MHA "
        f"form) [{smi}]")

    def sdpa_fwd_bwd():
        o_ = sdpa(qg, kg, vg, is_causal=True, scale=scale)
        torch.autograd.grad(o_, (qg, kg, vg), do)

    qf, kf, vf = (x.clone().requires_grad_() for x in (q, k, v))

    def flash_fwd_bwd():
        o_ = fa.flash_attention(qf, kf, vf, causal=True, scale=scale, layout="bhtd")
        torch.autograd.grad(o_, (qf, kf, vf), do)

    log(f"[timing] fwd+bwd {MODEL_SHAPE} causal: port {_time_ms(flash_fwd_bwd):.3f} ms, "
        f"sdpa {_time_ms(sdpa_fwd_bwd):.3f} ms, sdpa fwd {sdpa_fwd:.3f} ms [{smi}]")
    return out


def phase_reference() -> None:
    """A small Llama on the card (kernels) and on the CPU (plain versions),
    same weights and tokens: the losses and gradient norms agree."""
    import dataclasses

    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
    from mpi_operator_tpu_torch.ops.trainer import global_norm

    cfg = dataclasses.replace(
        llama.tiny(), d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512
    )
    host = next(synthetic_tokens(global_batch=2, seq_len=200, vocab=cfg.vocab, seed=3))
    results = {}
    cpu_model = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for dev in ("cuda", "cpu"):
        model = llama.Llama(cfg, device=dev)
        model.load_state_dict(cpu_model.state_dict())
        loss = llama.loss_fn(model, make_global_batch(host, dev))
        loss.backward()
        gnorm = global_norm([p.grad for p in model.parameters()])
        results[dev] = (loss.item(), gnorm.item())
    (l_gpu, g_gpu), (l_cpu, g_cpu) = results["cuda"], results["cpu"]
    log(f"[reference] small llama loss cuda {l_gpu:.6f} cpu {l_cpu:.6f}; "
        f"grad norm cuda {g_gpu:.6f} cpu {g_cpu:.6f}")
    if not (abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu) and abs(g_gpu - g_cpu) <= 5e-2 * g_cpu):
        fail("the small Llama on the card disagrees with its CPU reference")


def phase_main(smi: str) -> dict:
    """The benchmark entry point itself, ``bench.bench_llama``: it checks K1
    at the gate shape, then trains. The counts are zeroed here just before it
    and read just after; the benchmark zeroes them again after its K1 check,
    so what is read is the training run's launches alone."""
    from mpi_operator_tpu_torch import bench
    from mpi_operator_tpu_torch.kernels import flash_attention as fa

    seq_len, batch, warmup, steps = 2048, 4, 2, 5
    fa.reset_launches()
    rec = bench.bench_llama(
        seq_len=seq_len, per_chip_batch=batch, steps=steps, warmup=warmup, device="cuda"
    )
    launches = dict(fa.launches)
    losses = rec["losses"]
    log(f"[main] bench_single_chip: {rec['params']} params, batch {batch}, seq {seq_len}, "
        f"flash_kernel_max_err {rec['flash_kernel_max_err']:.3e}")
    for i, loss in enumerate(losses):
        log(f"[main] step {i} loss {loss:.6f}")
    log(f"[main] tokens/s {rec['value']:.1f}, step_ms {rec['step_ms']:.2f}, "
        f"mfu {rec['mfu']:.4f}, setup_s {rec['setup_s']:.2f}, warmup_s {rec['warmup_s']:.2f}, "
        f"max_memory_allocated {rec['max_memory_allocated']} [{smi}]")
    log(f"[main] kernel launches in {warmup + steps} steps: {launches}")
    if len(losses) != warmup + steps:
        fail(f"expected {warmup + steps} losses, got {len(losses)}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss on the main path: {losses}")
    if round(losses[0], 4) != MAIN_FIRST_LOSS or round(losses[-1], 4) != MAIN_LAST_LOSS:
        fail(f"the losses moved from {MAIN_FIRST_LOSS} -> {MAIN_LAST_LOSS}: {losses}")
    want = 12 * (warmup + steps)  # bench_single_chip's 12 layers, once per step each
    if launches != {name: want for name in REPLACES}:
        fail(f"expected {want} launches of each kernel on the main path, got {launches}")
    return launches


def _worker(env: dict, timeout: float) -> tuple:
    """One incarnation of the worker as the operator launches it; returns
    (exit code, its JSON record, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.workers.llama_worker"],
        env={**os.environ, **env}, cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=timeout,
    )
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if not lines or not lines[-1].startswith("{"):
        fail(f"the worker printed no record (rc {proc.returncode}):\n{proc.stderr[-3000:]}")
    return proc.returncode, json.loads(lines[-1]), wall


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def phase_gang(smi: str) -> dict:
    """The gang path: reference, restart, resume (see the module docstring).
    Returns each kernel's launches per step in the reference run."""
    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.runtime.stepstats import read_stats

    torch.cuda.empty_cache()
    ckpt_bytes = 3 * 4 * llama.param_count(llama.bench_single_chip())  # f32 params, mu, nu
    roots = [tempfile.gettempdir(), os.path.dirname(os.path.abspath(__file__))]
    frees = {r: shutil.disk_usage(r).free for r in roots}
    root = max(frees, key=frees.get)
    log(f"[gang] free bytes {frees}; a checkpoint is ~{ckpt_bytes} bytes")
    if frees[root] < 3 * ckpt_bytes:
        fail(f"under 3 checkpoints of free disk: {frees} < {3 * ckpt_bytes}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gang_", dir=root)
    try:
        base = {"LLAMA_CONFIG": "bench", "LLAMA_MESH": "fsdp=1", "LLAMA_SEQ": "2048",
                "LLAMA_BATCH": "4", "LLAMA_STEPS": "4", "LLAMA_SAVE_EVERY": "2",
                "LLAMA_CHECK_EVERY": "2", "TPUJOB_STEPSTATS_INTERVAL": "0"}
        rc, ref, wall = _worker(base, timeout=300)
        log(f"[gang] (a) reference: rc {rc}, {wall:.1f}s, {ref} [{smi}]")
        if rc != 0 or ref["outcome"] != "done" or len(ref["losses"]) != 4:
            fail(f"the reference run failed: rc {rc}, {ref}")
        cfg = os.path.join(tmp, "config")
        os.makedirs(cfg)
        elastic = {**base, "LLAMA_CKPT": os.path.join(tmp, "ckpt"), "TPUJOB_CONFIG_DIR": cfg}
        runs = {}
        for tag, hosts, want_rc in (("b", 2, 75), ("c", 1, 0)):
            with open(os.path.join(cfg, "hostfile"), "w") as f:
                f.write("".join(f"llama-worker-{i} slots=1\n" for i in range(hosts)))
            stats_path = os.path.join(tmp, f"stats_{tag}.json")
            rc, rec, wall = _worker({**elastic, "TPUJOB_STEPSTATS_FILE": stats_path},
                                    timeout=450)
            stats = read_stats(stats_path) or {}
            log(f"[gang] ({tag}) hostfile of {hosts}: rc {rc}, {wall:.1f}s, {rec}; "
                f"stepstats {stats} [{smi}]")
            if rc != want_rc:
                fail(f"run ({tag}) exited {rc}, expected {want_rc}")
            buckets = stats.get("buckets", {})
            if not (buckets.get("compute", 0) > 0 and buckets.get("ckpt", 0) > 0):
                fail(f"run ({tag}) has no compute or ckpt seconds in its step stats: {stats}")
            runs[tag] = (rec, buckets)
        (b, b_buckets), (c, c_buckets) = runs["b"], runs["c"]
        if (b["outcome"], b["step"], c["outcome"], c["start_step"], c["step"]) != \
                ("restart", 2, "done", 2, 4):
            fail(f"expected a restart at step 2 and a resume from 2 to 4: {b}, {c}")
        steps = os.path.join(tmp, "ckpt", "2")
        size = _tree_bytes(steps)
        rel = max(abs(x - y) / abs(y) for x, y in zip(b["losses"] + c["losses"], ref["losses"]))
        log(f"[gang] losses: reference {ref['losses']}, restart {b['losses']}, resume "
            f"{c['losses']}; largest relative difference {rel:.3e} (bound 1e-6)")
        log(f"[gang] checkpoint of step 2: {size} bytes; save_s {b_buckets['ckpt']:.3f} "
            f"(the ckpt seconds of run (b): its periodic save and the commit before exit 75), "
            f"restore_s {c['restore_s']:.3f} [{smi}]")
        if not rel <= 1e-6:
            fail(f"the restarted run's losses differ from the reference's: {rel}")
        per_step = {k: n / 4 for k, n in ref["kernel_launches"].items()}
        log(f"[gang] kernel launches per step: reference {per_step}, restart "
            f"{b['kernel_launches']} in 2 steps, resume {c['kernel_launches']} in 2 steps")
        if per_step != {k: 12.0 for k in REPLACES}:
            fail(f"expected 12 launches of each kernel per step: {per_step}")
        return per_step
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    smi = phase_device()
    resources = phase_build()
    errs = phase_kernels()
    times = phase_timing(smi)
    phase_reference()
    launches = phase_main(smi)
    phase_gang(smi)
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": CU_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            **times[name],
            **resources[name],
        }
        for name in REPLACES
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
