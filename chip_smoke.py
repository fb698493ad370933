"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the hand-written kernels from ``mpi_operator_tpu_torch/kernels/csrc``
   with nvcc, one process per source, all at once;
3. kernels: K1 (forward) and the backward (K3: dk/dv and dq's f32 sum by
   reduce-adds, then the dq pass), then the autograd path, each against its
   plain PyTorch version on the same inputs, bf16, causal and not, at the
   JAX bench's gate shape, the Llama model's shape and a ragged T. Ceilings: o 3e-2 abs, lse 1e-3 abs, dq/dk/dv 3e-2 x max|ref|;
   beside them every row (a query of o/dq, a key of dk/dv) is held to
   TOL_ROW relative to its own RMS, so late causal keys and queries, whose
   values are far below the tensor's max, are held too. At the model shape
   the smoke also shows that this check rejects a result whose last quarter
   of T is zero. The backward is also held, one launch over the whole
   tensor, at the two one-card decoder cells' attention shapes (B 1, T
   32768, H 32, Hkv 8, D 128 and B 8, T 4096, same heads) against the plain
   version run one q head at a time, with the same ceilings and per-row
   bound. Then K1, the backward, K3 alone, the dq pass alone, the zero
   fill, their plain versions and PyTorch's
   ``scaled_dot_product_attention`` (the yardstick, never on the port's
   path) timed with CUDA events at the model shape and at the long-context
   cell's (no plain version timed there), with TFLOP/s and share of the
   bound (the backward's and K3's: 5 products); SDPA's backward alone (dq,
   dk and dv in one call) is the backward's yardstick;
4. reference: a small Llama (head_dim 64; phase 9 runs tiny() at 16) on the
   card against the same weights on the CPU, where the plain versions run:
   loss and gradient norm agree;
5. main path: ``bench_single_chip()`` (~0.79B params) at seq 2048, batch 4,
   AdamW, through the benchmark entry point ``bench.bench_llama`` (its K1
   check, then 2 warm-up and 5 timed steps). Every loss is finite, the
   first is the recorded one (10.907693, within 1e-6: the batch is fixed) and
   the last within 1e-3 of 0.12461 (dq's sum order parts runs: three read
   0.124576-0.124788), and each kernel launches once per layer per step (84
   in 7 steps): the per-layer remat saves K1's outputs instead of running
   K1 again; K-norm, its finish and K-adamw (``kernels/optim.py``) launch
   once a step each (7), and K-rms (``kernels/rmsnorm.py``) 49 / 25 / 25
   times a step (343 / 175 / 175), zeroed with the others;
6. gang path: the worker as the operator runs it
   (``python -m mpi_operator_tpu_torch.workers.llama_worker``, one process
   per incarnation), ``bench_single_chip()`` at seq 2048, batch 4, on a
   one-rank NCCL group with ``LLAMA_MESH=fsdp=1`` (FSDP2's DTensor
   parameters around the kernels): (a) 4 steps, no checkpoint; (b) elastic,
   a hostfile of 2 hosts: saves at step 2 and exits 75; (c) the same
   checkpoint dir, a hostfile of 1 host: restores step 2, runs to 4 and
   exits 0. (b)'s and (c)'s losses equal (a)'s within 1e-6 relative at step
   0, before any backward, and within 5e-3 after (dq's reduce-adds run in no
   fixed order, so runs part by up to 9.8e-4 within 4 steps); their
   step-stats blobs have compute and ckpt seconds; the checkpoint's bytes,
   save and restore times are printed. The checkpoint (~9.5 GB) goes to a
   temporary directory in ``$TMPDIR`` or the checkout, whichever has more
   room; under 3 checkpoints of room the phase fails;
7. ring: the ring attention's per-rank fold
   (``parallel/ring_attention.fold_every_rank``), forward and backward, for
   all 4 ranks of a ``sequence=4`` ring in one process (NCCL refuses two
   ranks on one card, so the transport is left out), at
   ``bench_single_chip``'s heads (H 16, Hkv 4, D 128), B 1, T 16384 in 4
   blocks of 4096: K1 per non-future block (causal on the diagonal, full on
   older blocks), the backward per block with the merged lse. The merged o
   and lse and the summed dq, dk, dv are held against the plain versions
   over the whole T (the backward one q head at a time), with phase 3's
   ceilings and per-row bound, and so are the kernels launched once over
   the whole T; each kernel launches n(n+1)/2 = 10 times in the fold. The
   fold's time, and each kernel's 10 launches
   alone, are timed beside the same work as one launch over the whole T:
   the causal (q, k) pairs are the same, so the ratios are what splitting
   T costs (the merges and f32 sums, and grids a quarter the size).

8. small head dims: K1 and the backward at D 16 and 32 (the D-64 tiles, columns past D
   zero-filled by TMA, only D columns stored) against their plain
   versions with phase 3's ceilings and per-row bound, causal and full, at
   the worker's ``tiny`` shape (B 2, T 128, H 4, Hkv 2) and at B 4, T 2048,
   H 16, Hkv 4, where each kernel, its plain version and SDPA at the same D
   are timed;
9. the worker as ``examples/llama.yaml`` runs it: ``LLAMA_CONFIG=tiny``
   (head_dim 16, as it is), batch 2, seq 128, 3 steps, in a subprocess:
   backend cuda, outcome done, finite losses, each kernel launched;
10. profiling: the worker with a checkpoint dir and a projected ``profile``
   request for 2 steps: the step-stats blob acks ``done`` and the capture
   is a Chrome trace whose events include K1's kernel;
11. the kernel cache: two processes on one fresh
   ``TPUJOB_COMPILE_CACHE_DIR`` (``runtime/compile_cache.smoke``): the
   first builds (misses), the second runs no ``nvcc`` (hits, no misses);
   both set-up times are printed;
12. MoE and the pipeline: the MoE layer at the bench widths (d_model 2048,
   d_ff 7168, 8 experts, 4 x 2048 tokens, bf16) forward and backward,
   timed, and on 512 tokens against the CPU (3e-2 x max|y| and of each
   gradient); ``run_pipeline``'s fall-back (no ``pipe`` axis: NCCL puts
   no two ranks on one card) on the card against the CPU (1e-5). The
   multi-rank EP and PP steps are ``python -m mpi_operator_tpu_torch.dryrun
   4`` on four cards;
13. quant_matmul: the int8 and fp8 FFN products (``torch._int_mm``,
   ``torch._scaled_mm``: library calls, as ``lax.dot_general`` is in the
   JAX package) against their plain versions at the bench's FFN shapes
   (M 4 x 2048; d_model 2048 -> d_ff 7168 and back): int8 bit for bit, fp8
   within one bf16 ulp of each value plus 1e-3 of max (the f32 sums round
   in another order); ``quant_error``; each product timed beside the bf16
   ``torch.matmul`` of the shape and its bound (bytes, or operations at the
   card's int8 / fp8 peak);
14. the Llama bench at ``BENCH_QUANT=int8`` and ``fp8`` (``bench_llama``,
   batch 4, seq 2048, 1 warm-up and 3 timed steps each): finite losses whose
   first is within 5 % of the bf16 run's first (phase 5's, the same weights
   and batch), 12 launches of K1, K3 and the dq pass each a step, and 6 quantized products
   per layer a step (3 forward, 3 in the remat's recompute);
15. ResNet: resnet26 at image 64 on the card against the CPU from the same
   weights (loss 1e-2 relative, grad norm 5e-2, as phase 4 holds the Llama);
   then ``bench.bench_resnet`` at full width, ResNet-101, image 224, batch
   128, ``BENCH_INPUT=stream`` (uint8 batches through ``ops.data.prefetch``,
   the normalize on the card), its defaults (5 warm-up and 3 timed calls of
   10 steps), and the same with ``fixed`` input (2 warm-up calls): images/s,
   step ms, MFU, set-up seconds and peak memory, stream against fixed;
16. the workers as the operator launches them (``python -m
   mpi_operator_tpu_torch.workers.<name>`` with the executor's one-rank
   ``TPUJOB_*`` env, on the card): ResNet at ``examples/resnet.yaml``'s
   config, MNIST (20 steps) and π. tests/test_torch_operator_cuda.py runs
   the manifests themselves through the operator on the card.
17. the sliding window at the Trinity cell's attention (B 4, T 8192, H 32,
   Hkv 4, D 128, W 2048): K1 and the backward against their plain versions
   on two (batch row, kv head) groups, the first and the last, with phase
   3's ceilings and per-row bound, a window of T against the causal kernels (identical but for dq's
   reduce-add order), and K1, the backward and K3 alone timed, windowed and
   causal, beside their bound on the window's pairs;
18. the routed expert products at that cell's shape (128 experts x 2048
   rows, 2048 -> 1024): ``moe.grouped_mm`` (``torch._grouped_mm``, whose
   backward is the transposed grouped products) against single experts' products,
   timed beside its bound, one dense product of the same FLOPs and the
   per-expert loop;
19. a Trinity training step at that cell's widths and shapes (6 layers,
   vocabulary 25,024, B 4, T 8192, per-layer remat) through
   ``Trainer.train_step``, after one warm-up step, with ``launches`` zeroed
   just before it and the device traced: 6 launches of K1, K3 and the dq
   pass each, of which 5 of K1 and 5 of K3 are the windowed instances,
   48 grouped expert products (4 MoE layers x 3 products x the forward,
   the remat's recompute and the backward's two), one launch of
   K-norm, its finish and K-adamw each, and K-rms's forward 73 times (6
   norms a layer, again in the recompute, and the final one) and its
   backward and finish 37 times each, counted and in the trace.
20. the optimizer phase over the leaves of the benchmark's
   ``trinity-mini-l6`` and ``mistral-7b-l8`` (f32 parameters, gradients of
   norm 4 against max_norm 1, a bf16 first moment, weight decay 0.1): the
   clip and AdamW through K-norm and K-adamw (``kernels/optim.py``) and
   through their plain versions on the card (``sum_squares_plain``, a pass
   a leaf, and ``adamw_plain_``): K-norm's norm within 1e-6
   relative of the plain one; one step of each path, the plain norm given
   to both, on copies of one leaf of each shape, p, mu and nu bit for bit
   equal; K-norm, its finish and K-adamw launched as often as planned; both
   paths timed; K-norm and K-adamw
   alone beside their bound (4 and 24 bytes a parameter over the HBM
   rate); ``torch._fused_adamw_`` (f32 moments, no clip: the yardstick,
   never on the port's path) as ``library_ms``; the kernels' registers and
   spill bytes from ptxas.
21. K-rms (``kernels/rmsnorm.py``) at the cells' norms, each in its step's
   layout: the decoder's [32768, 4096] and Trinity's [32768, 2048] as
   [B, T, D], Trinity's q [4, 32, 8192, 128] and k [4, 4, 8192, 128] as the
   einsum's heads-major view of [B, T, H, Dh] storage, bf16, dy contiguous.
   Against ``rmsnorm_plain`` under autograd on the same inputs: y within one
   bf16 ulp, dx within one bf16 ulp plus 32 f32 ulps of its operands' size,
   dscale within 1e-5 of Σ|dy · x̂|. The forward and the backward timed by
   their device time in a profiler trace, each launch behind a 64 MB copy
   that evicts the L2 cache, beside their bound (4 and 6 bytes an element
   over the HBM rate), and launched back to back (host time included); the
   plain version's forward and its forward and backward, and
   ``torch.nn.functional.rms_norm`` (bf16 weight; the yardstick, never on
   the port's path) as ``library_ms``, by device time; the kernels'
   registers and spill bytes from ptxas.

The line before the last is a JSON object with one entry per kernel (its
registers and spill bytes per head dim from ptxas, from phase 7 its
launches as ``ring_launches`` and the fold-vs-whole times as ``ring_ms`` /
``ring_whole_ms``, from phase 3 its times (and the backward's errors) at
the long-context shape as ``long``, and from phase 8 its times at D 16 and 32 as ``small_d``,
beside its numbers); the last is
``{"ok": true, "device": {...}}``.
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
    # the dq call's emit: scale * acc, rounded
    "flash_bwd_dq": "mpi_operator_tpu/kernels/flash_attention.py:347",
    # K3: the products of both backward calls, S and dP computed once
    "flash_bwd_dkv": "mpi_operator_tpu/kernels/flash_attention.py:347+370",
}
CUDA_KERNEL = {  # launch count -> its __global__ function in CU_SOURCE
    "flash_fwd": "flash_fwd_kernel",
    "flash_bwd_dq": "flash_bwd_dq_kernel",
    "flash_bwd_dkv": "flash_bwd_dkv_kernel",
}
# The main path's first and last losses as recorded on the card, and how far each may
# move. The first precedes any backward and repeats to the printed digits; it is the
# forward with the norms in K-rms (the eager norms read 10.907811: K-rms sums a row's
# squares in another order, and y's bf16 rounding can land a ulp apart). After a
# backward, losses part from run to run: K3 adds dq's f32 sum up in no fixed order, a
# bf16 rounding of dq can flip, and AdamW's first steps carry the flip into the
# weights. Three runs' last losses lie within 1.8e-4 of 0.12461 (nine with the eager
# norms within 2.3e-4 of 0.12508); the bound is 1e-3.
MAIN_FIRST_LOSS, MAIN_FIRST_TOL = 10.907693, 1e-6
MAIN_LAST_LOSS, MAIN_LAST_TOL = 0.12461, 1e-3
# The gang's restart and resume against its reference, relative: exact before any
# backward; after one, the same parting. Losses of steps 1-3 of nine sound runs lie
# within 9.8e-4 of each other.
GANG_FIRST_REL, GANG_LOSS_REL = 1e-6, 5e-3
MODEL_SHAPE = (4, 2048, 16, 4, 128)  # B, T, H, Hkv, D of bench_single_chip at seq 2048
LONG_SHAPE = (1, 32768, 32, 8, 128)  # the benchmark's mistral-7b-l8.s32768 attention
S4096_SHAPE = (8, 4096, 32, 8, 128)  # the benchmark's mistral-7b-l8.s4096 attention
SHAPES = [
    ("gate", (2, 512, 8, 4, 64)),
    ("model", MODEL_SHAPE),
    ("ragged", (1, 1000, 8, 2, 128)),
]
# ceilings on the max abs error: o, lse, and dq/dk/dv as a share of max|ref|
TOL_O, TOL_LSE, TOL_GRAD_REL = 3e-2, 1e-3, 3e-2
# the tight check beside them: worst per-row relative RMS error (_row_err)
TOL_ROW, ROW_FLOOR = 1e-2, 0.1
RING_SHAPE, RING_N = (1, 16384, 16, 4, 128), 4  # B, T, H, Hkv, D; ranks of the ring
HEAD_DIMS = (16, 32, 64, 128)  # what the kernels are compiled at
WINDOW_DIMS = (64, 128)  # and their windowed instances
WINDOWED = ("flash_fwd_kernel", "flash_bwd_dkv_kernel")
# the benchmark's trinity-mini-l6.s8192-zipf attention (B, T, H, Hkv, D) and its window
WINDOW_SHAPE, WINDOW = (4, 8192, 32, 4, 128), 2048
# its routed expert products: 128 experts x 2048 rows (4 x 8192 tokens x top-8), 2048 -> 1024
GROUPED_SHAPE = (128, 2048, 2048, 1024)
SMALL_D = (16, 32)
# the worker's manifest env (examples/llama.yaml, as the operator test runs it)
MANIFEST_ENV = {"LLAMA_CONFIG": "tiny", "LLAMA_BATCH": "2", "LLAMA_SEQ": "128",
                "LLAMA_STEPS": "3"}
# the card's dense int8 / fp8 tensor-core peaks (NVIDIA data sheet, SXM)
QUANT_OPS_PER_S = {"int8": 1979e12, "fp8": 1979e12}
FFN_SHAPES = [(4 * 2048, 2048, 7168), (4 * 2048, 7168, 2048)]  # M, K, N of the bench's FFN
# examples/resnet.yaml's worker env, and the executor's env of a one-rank job
RESNET_MANIFEST_ENV = {"RESNET_DEPTH": "resnet26", "RESNET_BATCH": "4", "RESNET_STEPS": "3",
                       "RESNET_IMAGE": "64", "RESNET_CLASSES": "10"}
ONE_RANK_ENV = {"TPUJOB_NUM_HOSTS": "1", "TPUJOB_HOST_ID": "0", "TPUJOB_CHIPS_PER_HOST": "1"}


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
    spill bytes (stores + loads) of its kernel at each head dim (the dq
    pass has one instance for all)."""
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
        # K1 and K3 are instances <D, WIN>: WIN 0 the causal kernel, WIN 1 the
        # windowed one (at WINDOW_DIMS); the dq pass has no template
        keys = [(str(d), f"{kernel}<{d},0>") for d in HEAD_DIMS]
        keys += [(f"{d}w", f"{kernel}<{d},1>") for d in WINDOW_DIMS]
        if kernel not in WINDOWED:
            keys = [(str(d), kernel) for d in HEAD_DIMS]
        for label, key in keys:
            r = res.get(key)
            if r is None:
                fail(f"ptxas reported nothing for {key}")
            regs[label] = r["registers"]
            spills[label] = r["spill_stores"] + r["spill_loads"]
        log(f"[build] {kernel}: registers {regs}, spill bytes {spills} (per D; w: windowed)")
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


def _check_shape(label: str, shape, causal: bool, seed: int, power: bool = False) -> dict:
    """K1, the backward and the autograd path at one shape against the plain
    versions; returns each kernel's worst max abs error (the backward's dq
    under the dq pass). ``power``: also
    show that the per-row check rejects a zeroed last quarter of T."""
    from mpi_operator_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = _inputs(shape, seed=seed)
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
        dq_ref, dk_ref, dv_ref = fa.flash_bwd_plain(*args)
        dq, dk, dv = fa.flash_bwd_cuda(*args)
        torch.cuda.synchronize()
        e_dq = _check(f"K3 + dq pass dq {tag}", dq, dq_ref, _grad_bound(dq_ref))
        e_dk = _check(f"K3 dk {tag}", dk, dk_ref, _grad_bound(dk_ref))
        e_dv = _check(f"K3 dv {tag}", dv, dv_ref, _grad_bound(dv_ref))
        if power:
            for name, ref in (("o", o_ref), ("dq", dq_ref), ("dk", dk_ref), ("dv", dv_ref)):
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
    del q, k, v, do, o_ref, lse_ref, dq_ref, dk_ref, dv_ref, qg, kg, vg, out, grads
    torch.cuda.empty_cache()
    return {"flash_fwd": max(e_o, e_lse), "flash_bwd_dq": e_dq, "flash_bwd_dkv": max(e_dk, e_dv)}


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the worst abs error
    per kernel at the model shape."""
    errs = {}
    for i, (label, shape) in enumerate(SHAPES):
        for causal in (True, False):
            model = label == "model" and causal
            e = _check_shape(label, shape, causal, seed=2 * i + causal, power=model)
            if model:
                errs = e
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


def phase_timing(smi: str, shape=MODEL_SHAPE, plain: bool = True) -> dict:
    """Times (ms) at ``shape`` (the model shape by default), causal, of K1;
    of the backward (launch count ``flash_bwd_dkv``: its accumulator's zero
    fill, K3 and the dq pass), with ``k3_ms`` K3 alone (adding into one
    accumulator allocated once) and ``fill_ms`` the fill alone; of the dq
    pass alone (``flash_bwd_dq``); of their plain versions (with ``plain``)
    and of the SDPA yardstick."""
    from mpi_operator_tpu_torch.kernels import flash_attention as fa

    b, t, h, h_kv, d = shape
    scale = d ** -0.5
    q, k, v, do = _inputs(shape, seed=11)
    with torch.no_grad():
        o, lse = fa.flash_fwd_cuda(q, k, v, True, scale)
        delta = (do.float() * o.float()).sum(-1)
        acc = torch.randn(b, h, t, d, device="cuda")
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
                _bound(shape, 2, n_q + 2 * n_kv, n_q + n_row), sdpa_fwd,
            ),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq_cuda(acc, scale),
                lambda: (acc * scale).to(torch.bfloat16),
                _bound(shape, 0, 2 * n_q, n_q), None,
            ),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_cuda(*args),
                lambda: fa.flash_bwd_plain(*args),
                _bound(shape, 5, 2 * n_q + 2 * n_kv + 2 * n_row, n_q + 2 * n_kv), None,
            ),
        }
        for name, (kernel, plain_fn, (bound_ms, bound_by, flops), lib_ms) in specs.items():
            ms = _time_ms(kernel)
            plain_ms = _time_ms(plain_fn, reps=2) if plain else None
            tflops = flops / (ms * 1e-3) / 1e12
            out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=lib_ms, tflops=tflops, bound_share=bound_ms / ms)
            log(f"[timing] {name} {shape} causal: kernel {ms:.4f} ms "
                f"({tflops:.1f} TFLOP/s, {100 * bound_ms / ms:.1f} % of bound), plain "
                f"{'n/a' if plain_ms is None else f'{plain_ms:.3f} ms'}, bound {bound_ms:.4f} ms "
                f"({bound_by}), sdpa {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} [{smi}]")
        fill_ms = _time_ms(lambda: torch.zeros(b, h, t, d, dtype=torch.float32, device="cuda"))
        # K3 alone: adding into a non-zero accumulator costs what adding into zeros does
        k3_ms = _time_ms(lambda: fa.flash_bwd_dkv_cuda(*args[:6], acc, True, scale))
    del acc
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k_x, v_x))
    # SDPA's backward alone: its forward runs once, outside the timed window
    o_sdpa = sdpa(qg, kg, vg, is_causal=True, scale=scale)
    sdpa_bwd = _time_ms(lambda: torch.autograd.grad(o_sdpa, (qg, kg, vg), do, retain_graph=True))
    del o_sdpa
    bwd_ms, dq_ms = out["flash_bwd_dkv"]["ms"], out["flash_bwd_dq"]["ms"]
    out["flash_bwd_dkv"].update(k3_ms=k3_ms, fill_ms=fill_ms,
                                k3_bound_share=out["flash_bwd_dkv"]["bound_ms"] / k3_ms)
    for name in out:
        out[name]["sdpa_bwd_ms"] = sdpa_bwd
    log(f"[timing] bwd {shape} causal: {bwd_ms:.4f} ms; each alone: K3 {k3_ms:.4f} "
        f"({100 * out['flash_bwd_dkv']['k3_bound_share']:.1f} % of the 5-product bound), dq "
        f"pass {dq_ms:.4f}, zero fill {fill_ms:.4f} (sum {k3_ms + dq_ms + fill_ms:.4f}); "
        f"sdpa backward alone {sdpa_bwd:.4f} ms (dq, dk, dv of the MHA form) [{smi}]")

    def sdpa_fwd_bwd():
        o_ = sdpa(qg, kg, vg, is_causal=True, scale=scale)
        torch.autograd.grad(o_, (qg, kg, vg), do)

    qf, kf, vf = (x.clone().requires_grad_() for x in (q, k, v))

    def flash_fwd_bwd():
        o_ = fa.flash_attention(qf, kf, vf, causal=True, scale=scale, layout="bhtd")
        torch.autograd.grad(o_, (qf, kf, vf), do)

    log(f"[timing] fwd+bwd {shape} causal: port {_time_ms(flash_fwd_bwd):.3f} ms, "
        f"sdpa {_time_ms(sdpa_fwd_bwd):.3f} ms, sdpa fwd {sdpa_fwd:.3f} ms [{smi}]")
    del q, k, v, do, qg, kg, vg, qf, kf, vf, k_x, v_x
    torch.cuda.empty_cache()
    return out


def _plain_bwd_by_head(q, k, v, do, lse, delta, causal: bool, scale: float):
    """``flash_bwd_plain``'s arithmetic one q head at a time, since over a
    whole kv head it holds [g, T, T] f32 scores (4.3 GB a q head at T
    32768): dq per head, dk and dv summed over each kv head's q-head group
    in f32, then rounded as the plain version rounds them."""
    from mpi_operator_tpu_torch.kernels import flash_attention as fa

    h, h_kv = q.shape[1], k.shape[1]
    g = h // h_kv
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, device=k.device)
    dv = torch.zeros(v.shape, device=v.device)
    for i in range(h):
        j, hs, ks = i // g, slice(i, i + 1), slice(i // g, i // g + 1)
        p, ds = fa._bwd_probs(q[:, hs], k[:, ks], v[:, ks], do[:, hs], lse[:, hs],
                              delta[:, hs], causal, scale)
        ds = ds.to(k.dtype).float()[:, 0, 0]  # [B, T, T], rounded as each product's operand
        dq[:, i] = (torch.bmm(ds, k[:, j].float()) * scale).to(q.dtype)
        dk[:, j] += torch.bmm(ds.transpose(1, 2), q[:, i].float()) * scale
        del ds
        dv[:, j] += torch.bmm(p.to(do.dtype).float()[:, 0, 0].transpose(1, 2), do[:, i].float())
        del p
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def phase_long(smi: str) -> dict:
    """The backward (K3 and the dq pass, one launch over the whole tensor)
    at the two one-card decoder cells' attention shapes, causal, against
    ``_plain_bwd_by_head`` with phase 3's ceilings and per-row bound: at T
    32768 256 k tiles add into a late dq row. lse and delta come from K1,
    the same inputs on both sides. Returns each backward kernel's worst max
    abs error over both shapes."""
    from mpi_operator_tpu_torch.kernels import flash_attention as fa

    errs = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for label, shape in (("s32768", LONG_SHAPE), ("s4096", S4096_SHAPE)):
        torch.cuda.empty_cache()
        q, k, v, do = _inputs(shape, seed=31)
        scale = shape[4] ** -0.5
        tag = f"{label} causal {shape}"
        with torch.no_grad():
            o, lse = fa.flash_fwd_cuda(q, k, v, True, scale)
            delta = (do.float() * o.float()).sum(-1)
            args = (q, k, v, do, lse, delta, True, scale)
            got = fa.flash_bwd_cuda(*args)
            t0 = time.perf_counter()
            refs = _plain_bwd_by_head(*args)
            torch.cuda.synchronize()
            log(f"[long] plain backward by q head {tag}: {time.perf_counter() - t0:.1f} s")
            for name, gt, r in zip(("dq", "dk", "dv"), got, refs):
                e = _check(f"K3 + dq pass {name} {tag}", gt, r, _grad_bound(r))
                key = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
                errs[key] = max(errs[key], e)
        del q, k, v, do, o, lse, delta, args, got, refs
    torch.cuda.empty_cache()
    return errs


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


def phase_main(smi: str) -> tuple:
    """The benchmark entry point itself, ``bench.bench_llama``: it checks K1
    at the gate shape, then trains. The counts are zeroed here just before it
    and read just after; the benchmark zeroes them again after its K1 check,
    so what is read is the training run's launches alone. Returns them and
    the first loss."""
    from mpi_operator_tpu_torch import bench
    from mpi_operator_tpu_torch.kernels import flash_attention as fa
    from mpi_operator_tpu_torch.kernels import optim
    from mpi_operator_tpu_torch.kernels import rmsnorm as krms

    seq_len, batch, warmup, steps = 2048, 4, 2, 5
    fa.reset_launches()
    optim.reset_launches()
    krms.reset_launches()
    rec = bench.bench_llama(
        seq_len=seq_len, per_chip_batch=batch, steps=steps, warmup=warmup, device="cuda"
    )
    launches = dict(fa.launches)
    optim_launches = dict(optim.launches)
    rms_launches = dict(krms.launches)
    losses = rec["losses"]
    log(f"[main] bench_single_chip: {rec['params']} params, batch {batch}, seq {seq_len}, "
        f"flash_kernel_max_err {rec['flash_kernel_max_err']:.3e}")
    for i, loss in enumerate(losses):
        log(f"[main] step {i} loss {loss:.6f}")
    log(f"[main] tokens/s {rec['value']:.1f}, step_ms {rec['step_ms']:.2f}, "
        f"mfu {rec['mfu']:.4f}, setup_s {rec['setup_s']:.2f}, warmup_s {rec['warmup_s']:.2f}, "
        f"max_memory_allocated {rec['max_memory_allocated']} [{smi}]")
    log(f"[main] kernel launches in {warmup + steps} steps: {launches}, optimizer "
        f"{optim_launches}, K-rms {rms_launches}")
    if len(losses) != warmup + steps:
        fail(f"expected {warmup + steps} losses, got {len(losses)}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss on the main path: {losses}")
    if not (abs(losses[0] - MAIN_FIRST_LOSS) <= MAIN_FIRST_TOL
            and abs(losses[-1] - MAIN_LAST_LOSS) <= MAIN_LAST_TOL):
        fail(f"the losses moved from {MAIN_FIRST_LOSS} -> {MAIN_LAST_LOSS} by more than "
             f"{MAIN_FIRST_TOL} / {MAIN_LAST_TOL}: {losses}")
    want = 12 * (warmup + steps)  # bench_single_chip's 12 layers, once per step each
    if launches != {name: want for name in REPLACES}:
        fail(f"expected {want} launches of each kernel on the main path, got {launches}")
    # the optimizer's kernels: K-norm, its finish and K-adamw once a step
    if optim_launches != {name: warmup + steps for name in optim.launches}:
        fail(f"expected {warmup + steps} launches of each optimizer kernel on the main path, "
             f"got {optim_launches}")
    # K-rms: 2 norms a layer and the final one; each layer's two again in its
    # recompute, every norm once in the backward
    norms = 2 * 12 + 1
    want_rms = {name: n * (warmup + steps) for name, n in
                (("rms_fwd", 2 * norms - 1), ("rms_bwd", norms), ("rms_bwd_finish", norms))}
    if rms_launches != want_rms:
        fail(f"expected K-rms launches {want_rms} on the main path, got {rms_launches}")
    return launches, losses[0]


def _run_worker(module: str, env: dict, timeout: float, args=()) -> tuple:
    """One incarnation of a worker as the operator launches it; returns
    (exit code, its last stdout line, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"mpi_operator_tpu_torch.workers.{module}", *args],
        env={**os.environ, **env}, cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=timeout,
    )
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if not lines:
        fail(f"{module} printed nothing (rc {proc.returncode}):\n{proc.stderr[-3000:]}")
    return proc.returncode, lines[-1], wall


def _worker(env: dict, timeout: float) -> tuple:
    """One incarnation of the Llama worker; returns (exit code, its JSON
    record, wall seconds)."""
    rc, line, wall = _run_worker("llama_worker", env, timeout)
    if not line.startswith("{"):
        fail(f"the worker printed no record (rc {rc}): {line}")
    return rc, json.loads(line), wall


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
        rels = [abs(x - y) / abs(y) for x, y in zip(b["losses"] + c["losses"], ref["losses"])]
        first, rel = rels[0], max(rels[1:])
        log(f"[gang] losses: reference {ref['losses']}, restart {b['losses']}, resume "
            f"{c['losses']}; relative difference before any backward {first:.3e} (bound "
            f"{GANG_FIRST_REL:.0e}), largest after {rel:.3e} (bound {GANG_LOSS_REL:.0e})")
        log(f"[gang] checkpoint of step 2: {size} bytes; save_s {b_buckets['ckpt']:.3f} "
            f"(the ckpt seconds of run (b): its periodic save and the commit before exit 75), "
            f"restore_s {c['restore_s']:.3f} [{smi}]")
        if not (first <= GANG_FIRST_REL and rel <= GANG_LOSS_REL):
            fail(f"the restarted run's losses differ from the reference's: {first}, {rel}")
        per_step = {k: n / 4 for k, n in ref["kernel_launches"].items()}
        log(f"[gang] kernel launches per step: reference {per_step}, restart "
            f"{b['kernel_launches']} in 2 steps, resume {c['kernel_launches']} in 2 steps")
        if per_step != {k: 12.0 for k in REPLACES}:
            fail(f"expected 12 launches of each kernel per step: {per_step}")
        return per_step
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _plain_whole(q, k, v, do, scale: float):
    """(o, lse, dq, dk, dv) of the plain versions over the whole T,
    causal: the forward in one call (it walks the kernel's tiles), the
    backward one q head at a time (``_plain_bwd_by_head``)."""
    from mpi_operator_tpu_torch.kernels import flash_attention as fa
    from mpi_operator_tpu_torch.parallel import ring_attention as ra

    o, lse = fa.flash_fwd_plain(q, k, v, True, scale)
    delta = ra.attention_delta(do, o)
    return (o, lse, *_plain_bwd_by_head(q, k, v, do, lse, delta, True, scale))


def phase_ring(smi: str) -> dict:
    """Phase 7 (see the module docstring). Returns each kernel's launches in
    the fold, and the fold's and the whole-T kernels' times (ms)."""
    from mpi_operator_tpu_torch.kernels import flash_attention as fa
    from mpi_operator_tpu_torch.parallel import ring_attention as ra

    b, t, h, h_kv, d = RING_SHAPE
    scale = d ** -0.5
    q, k, v, do = _inputs(RING_SHAPE, seed=21)
    tag = f"{RING_SHAPE} causal, sequence={RING_N}"

    def whole():
        o, lse = fa.flash_fwd_cuda(q, k, v, True, scale)
        delta = ra.attention_delta(do, o)
        return (o, lse, *fa.flash_bwd_cuda(q, k, v, do, lse, delta, True, scale))

    def fold():
        return ra.fold_every_rank(q, k, v, do, RING_N, causal=True, scale=scale)

    torch.cuda.empty_cache()
    with torch.no_grad():
        fa.reset_launches()
        got = fold()
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        log(f"[ring] kernel launches in the fold of {RING_N} ranks: {launches}")
        want = RING_N * (RING_N + 1) // 2
        if launches != {name: want for name in REPLACES}:
            fail(f"expected {want} launches of each kernel in the ring's fold, got {launches}")
        refs = _plain_whole(q, k, v, do, scale)
        for label, res in (("ring fold", got), ("whole-T kernels", whole())):
            for name, g, r in zip(("o", "lse", "dq", "dk", "dv"), res, refs):
                if name == "lse":
                    e = _max_err(g, r)
                    log(f"[ring] {label} lse {tag}: max abs err {e:.3e} (bound {TOL_LSE:.1e})")
                    if not e <= TOL_LSE:
                        fail(f"{label}: lse disagrees with K1's plain version: {e}")
                else:
                    _check(f"{label} {name} {tag}", g, r,
                           TOL_O if name == "o" else _grad_bound(r))
        # each kernel alone: its launches in the fold (the whole-T lse and
        # delta in place of the merged ones: the same work) against one
        # launch over the whole T
        o_ref, lse = refs[:2]
        delta = ra.attention_delta(do, o_ref)
        del got, refs, o_ref
        qs, ks, vs, dos, lses, deltas = ([c.contiguous() for c in x.chunk(RING_N, dim=2)]
                                         for x in (q, k, v, do, lse, delta))
        visits = [(i, j, ra.block_causality(i, j, True))
                  for i in range(RING_N) for j in range(i + 1)]

        def per_block(kernel, *with_grads):
            def run():
                for i, j, how in visits:
                    grads = (dos[i], lses[i], deltas[i]) if with_grads else ()
                    kernel(qs[i], ks[j], vs[j], *grads, how, scale)
            return run

        # the dq pass alone, over each visit's accumulator and over the whole T's
        accs = [torch.zeros(qs[i].shape, device="cuda") for i, _, _ in visits]
        acc = torch.zeros(q.shape, device="cuda")
        bwd = (do, lse, delta)
        per_kernel = {
            "flash_fwd": (per_block(fa.flash_fwd_cuda),
                          lambda: fa.flash_fwd_cuda(q, k, v, True, scale)),
            "flash_bwd_dq": (lambda: [fa.flash_bwd_dq_cuda(a, scale) for a in accs],
                             lambda: fa.flash_bwd_dq_cuda(acc, scale)),
            "flash_bwd_dkv": (per_block(fa.flash_bwd_cuda, True),
                              lambda: fa.flash_bwd_cuda(q, k, v, *bwd, True, scale)),
        }
        times = {name: {"ring_ms": _time_ms(f, reps=5), "ring_whole_ms": _time_ms(w, reps=5)}
                 for name, (f, w) in per_kernel.items()}
        fold_ms, whole_ms = _time_ms(fold, reps=5), _time_ms(whole, reps=5)
    for name, tm in times.items():
        log(f"[timing] ring {name} {tag}: {want} launches in the fold {tm['ring_ms']:.3f} ms, "
            f"one over the whole T {tm['ring_whole_ms']:.3f} ms, ratio "
            f"{tm['ring_ms'] / tm['ring_whole_ms']:.3f} [{smi}]")
    log(f"[timing] ring {tag}: fold of every rank (K1 x{want}, K3 and the dq pass x{want}, "
        f"merges) {fold_ms:.3f} ms, K1, K3 and the dq pass over the whole T {whole_ms:.3f} ms, "
        f"ratio {fold_ms / whole_ms:.3f} [{smi}]")
    return {"launches": launches, "times": times, "fold_ms": fold_ms, "whole_ms": whole_ms}


def phase_small_d(smi: str) -> dict:
    """Phase 8: K1 and the backward at D 16 and 32 against the plain versions at the
    worker's tiny shape and at B 4, T 2048, H 16, Hkv 4, where each kernel,
    its plain version and SDPA are timed. Returns, per kernel and D, the
    times and the worst max abs error."""
    out = {name: {} for name in REPLACES}
    for d in SMALL_D:
        errs = {name: 0.0 for name in REPLACES}
        for i, (label, shape) in enumerate((("tiny", (2, 128, 4, 2, d)),
                                            ("wide", (4, 2048, 16, 4, d)))):
            for causal in (True, False):
                e = _check_shape(f"D{d} {label}", shape, causal, seed=40 + 2 * i + causal)
                errs = {name: max(errs[name], e[name]) for name in REPLACES}
        times = phase_timing(smi, (4, 2048, 16, 4, d))
        for name in REPLACES:
            out[name][str(d)] = {**times[name], "max_abs_err": errs[name]}
    return out


def _window_bound(shape, window: int, n_matmuls: int):
    """(least time in ms, FLOP) of ``n_matmuls`` products over the pairs a
    sliding window lets through, at the bf16 peak (operations bound them)."""
    b, t, h, _, d = shape
    w = min(window, t)
    pairs = w * (w + 1) // 2 + (t - w) * w
    flops = 2 * n_matmuls * b * h * d * pairs
    return 1e3 * flops / BF16_FLOPS_PER_S, flops


def phase_window(smi: str) -> dict:
    """Phase 17: the sliding window at the Trinity cell's attention (B 4, T
    8192, H 32, Hkv 4, D 128, W 2048). K1 and the backward against their
    plain versions on two groups of a kv head's 8 q heads, batch row 0's
    first kv head and the last row's last (the plain backward's f32 tiles
    of T x T do not fit whole), with phase 3's ceilings and per-row bound;
    W >= T against the causal kernels (K1 and dk/dv bit for bit, dq within
    its reduce-add order); then K1, the backward and K3 alone, windowed and
    causal, timed with CUDA events beside their bound (operations on the
    window's pairs) and the plain versions on the last group. Returns each
    kernel's times."""
    from mpi_operator_tpu_torch.kernels import flash_attention as fa

    b, t, h, h_kv, d = WINDOW_SHAPE
    scale = d ** -0.5
    q, k, v, do = _inputs(WINDOW_SHAPE, seed=17)
    g = h // h_kv
    tag = f"{WINDOW_SHAPE} W {WINDOW}"
    with torch.no_grad():
        o, lse = fa.flash_fwd_cuda(q, k, v, True, scale, WINDOW)
        delta = (do.float() * o.float()).sum(-1)
        dq, dk, dv = fa.flash_bwd_cuda(q, k, v, do, lse, delta, True, scale, WINDOW)
        torch.cuda.synchronize()
        # (batch row, kv head) groups far apart: the first and the last
        for row, head in ((0, 0), (b - 1, h_kv - 1)):
            part = (slice(row, row + 1), slice(head * g, (head + 1) * g))
            kv = (slice(row, row + 1), slice(head, head + 1))
            one = (q[part], k[kv], v[kv], do[part])
            where = f"{tag} batch {row} kv head {head}"
            o_ref, lse_ref = fa.flash_fwd_plain(*one[:3], True, scale, window=WINDOW)
            _check(f"K1 o windowed {where}", o[part], o_ref, TOL_O)
            e_lse = _max_err(lse[part], lse_ref)
            log(f"[window] K1 lse {where}: max abs err {e_lse:.3e} (bound {TOL_LSE:.1e})")
            if not e_lse <= TOL_LSE:
                fail(f"K1 lse windowed disagrees with its plain version: {e_lse}")
            refs = fa.flash_bwd_plain(*one, lse[part], delta[part], True, scale, WINDOW)
            for name, got, ref in zip(("dq", "dk", "dv"), (dq[part], dk[kv], dv[kv]), refs):
                _check(f"K3 {name} windowed {where}", got, ref, _grad_bound(ref))
            del refs, o_ref, lse_ref
        # a window of T or more is the causal mask
        o_c, lse_c = fa.flash_fwd_cuda(q, k, v, True, scale)
        o_t, lse_t = fa.flash_fwd_cuda(q, k, v, True, scale, t)
        delta_c = (do.float() * o_c.float()).sum(-1)
        acc_c, acc_t = (torch.zeros(q.shape, device="cuda") for _ in range(2))
        dkv_c = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_c, delta_c, acc_c, True, scale)
        dkv_t = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_c, delta_c, acc_t, True, scale, t)
        torch.cuda.synchronize()
        same = (torch.equal(o_c, o_t) and torch.equal(lse_c, lse_t)
                and all(torch.equal(a, c) for a, c in zip(dkv_c, dkv_t)))
        e_acc = _max_err(acc_c, acc_t) / float(acc_c.abs().max())
        log(f"[window] W {t} >= T against causal: K1 and dk/dv identical {same}, dq's f32 "
            f"sum {e_acc:.2e} of its max (bound 1e-5)")
        if not (same and e_acc <= 1e-5):
            fail("a window of T does not give the causal kernels' result")
        del o_c, lse_c, o_t, lse_t, acc_c, acc_t, dkv_c, dkv_t
        torch.cuda.empty_cache()
        acc = torch.zeros(q.shape, device="cuda")
        out = {}
        args = (q, k, v, do, lse, delta)
        plain_one = (one, lse[part], delta[part])
        for win in (WINDOW, 0):
            label = f"W {win}" if win else "causal"
            fwd_ms = _time_ms(lambda: fa.flash_fwd_cuda(q, k, v, True, scale, win))
            bwd_ms = _time_ms(lambda: fa.flash_bwd_cuda(*args, True, scale, win))
            k3_ms = _time_ms(lambda: fa.flash_bwd_dkv_cuda(*args, acc, True, scale, win))
            fwd_bound, fwd_flops = _window_bound(WINDOW_SHAPE, win or t, 2)
            bwd_bound, _ = _window_bound(WINDOW_SHAPE, win or t, 5)
            plain_fwd = _time_ms(lambda: fa.flash_fwd_plain(*one[:3], True, scale, window=win),
                                 reps=1)
            plain_bwd = _time_ms(lambda: fa.flash_bwd_plain(
                *plain_one[0], *plain_one[1:], True, scale, win), reps=1)
            out[label] = {"flash_fwd_ms": fwd_ms, "flash_fwd_bound_ms": fwd_bound,
                          "flash_bwd_ms": bwd_ms, "k3_ms": k3_ms, "k3_bound_ms": bwd_bound,
                          "plain_fwd_ms_one_group": plain_fwd,
                          "plain_bwd_ms_one_group": plain_bwd}
            log(f"[window] {label} {WINDOW_SHAPE}: K1 {fwd_ms:.3f} ms "
                f"({100 * fwd_bound / fwd_ms:.1f} % of {fwd_bound:.3f}), backward "
                f"{bwd_ms:.3f} ms, K3 alone {k3_ms:.3f} ms "
                f"({100 * bwd_bound / k3_ms:.1f} % of {bwd_bound:.3f}); plain on 1 of "
                f"{b * h_kv} (batch, kv head) groups: K1 {plain_fwd:.2f} ms, backward "
                f"{plain_bwd:.2f} ms [{smi}]")
    del q, k, v, do, o, lse, delta, dq, dk, dv, acc
    torch.cuda.empty_cache()
    return out


def phase_grouped(smi: str) -> dict:
    """Phase 18: the routed expert products at the Trinity cell's shape (128
    experts x 2048 rows, 2048 -> 1024, bf16): ``moe.grouped_mm``
    (``torch._grouped_mm``) forward, and its backward's two transposed
    grouped products, against three single experts' products, timed beside
    their bound, one dense ``torch.matmul`` of the same FLOPs (the
    yardstick) and the per-expert loop."""
    from mpi_operator_tpu_torch.parallel import moe

    e, rows, k_dim, n = GROUPED_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(18)
    x = (torch.randn(e * rows, k_dim, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    w = (torch.randn(e, k_dim, n, generator=gen, device="cuda") * 0.03).to(torch.bfloat16)
    dy = (torch.randn(e * rows, n, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    ends = torch.arange(1, e + 1, device="cuda", dtype=torch.int32) * rows
    with torch.no_grad():
        y = moe.grouped_mm(x, w, ends)
        for i in (0, e // 2, e - 1):
            r = slice(i * rows, (i + 1) * rows)
            err = _max_err(y[r], x[r] @ w[i]) / float((x[r] @ w[i]).float().abs().max())
            if not err <= 1e-2:
                fail(f"grouped_mm disagrees with the product of expert {i}: {err}")
    flops = 2.0 * e * rows * k_dim * n
    bound_ms = 1e3 * flops / BF16_FLOPS_PER_S
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()

    def fwd_bwd():
        y_ = moe.grouped_mm(xg, wg, ends)
        torch.autograd.grad(y_, (xg, wg), dy)

    with torch.no_grad():
        fwd_ms = _time_ms(lambda: moe.grouped_mm(x, w, ends))
        dense_ms = _time_ms(lambda: x @ w[0])
        loop_ms = _time_ms(lambda: moe.grouped_mm_plain(x, w, ends), reps=3)
    fb_ms = _time_ms(fwd_bwd)
    out = {"fwd_ms": fwd_ms, "bound_ms": bound_ms, "fwd_bwd_ms": fb_ms,
           "library_dense_ms": dense_ms, "plain_loop_ms": loop_ms}
    log(f"[grouped] {e} experts x {rows} rows, {k_dim} -> {n} bf16: forward {fwd_ms:.3f} ms "
        f"({100 * bound_ms / fwd_ms:.1f} % of {bound_ms:.3f}), forward + backward {fb_ms:.3f} ms "
        f"({100 * 3 * bound_ms / fb_ms:.1f} % of 3 products), one dense matmul of the same "
        f"FLOPs {dense_ms:.3f} ms, per-expert loop {loop_ms:.3f} ms [{smi}]")
    return out


TRINITY_STEP = {"n_layers": 6, "vocab": 25_024, "batch": 4, "seq": 8192}


def phase_trinity_step(smi: str) -> dict:
    """Phase 19: one Trinity training step at the cell's widths and shapes
    (``models.MODELS["trinity-mini"]`` cut to 6 layers and 25,024 ids, B 4,
    T 8192, per-layer remat, AdamW) through ``Trainer.train_step``, after a
    warm-up step: ``launches`` zeroed just before it, and its device kernels
    counted by name in a ``torch.profiler`` trace. Returns the counts."""
    import dataclasses
    import functools

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from mpi_operator_tpu_torch.kernels import flash_attention as fa
    from mpi_operator_tpu_torch.kernels import optim
    from mpi_operator_tpu_torch.kernels import rmsnorm as krms
    from mpi_operator_tpu_torch.models import MODELS, llama
    from mpi_operator_tpu_torch.ops.data import make_global_batch
    from mpi_operator_tpu_torch.ops.trainer import Trainer, TrainerConfig

    module, factory = MODELS["trinity-mini"]
    n = TRINITY_STEP
    cfg = dataclasses.replace(factory(), n_layers=n["n_layers"], vocab=n["vocab"],
                              remat_layers=True)
    model = module.init(cfg, torch.Generator(device="cuda").manual_seed(19), "cuda")
    trainer = Trainer(functools.partial(llama.loss_fn, ce_chunk=2048),
                      TrainerConfig(learning_rate=3e-4, warmup_steps=2000, adam_mu_bf16=True))
    state = trainer.init_state(model)
    rng = np.random.default_rng(19)
    host = {"tokens": rng.integers(0, n["vocab"], (n["batch"], n["seq"]), dtype=np.int32)}
    batch = make_global_batch(host, "cuda")
    state, _ = trainer.train_step(state, batch)  # warm-up: every shape built
    torch.cuda.synchronize()
    fa.reset_launches()
    optim.reset_launches()
    krms.reset_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(fa.launches)
    optim_launches = dict(optim.launches)
    rms_launches = dict(krms.launches)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = {
        "flash_fwd windowed": sum("flash_fwd_kernel<128, 1>" in x for x in names),
        "flash_fwd causal": sum("flash_fwd_kernel<128, 0>" in x for x in names),
        "flash_bwd_dkv windowed": sum("flash_bwd_dkv_kernel<128, 1>" in x for x in names),
        "flash_bwd_dkv causal": sum("flash_bwd_dkv_kernel<128, 0>" in x for x in names),
        "grouped products": sum("GroupProblemShape" in x for x in names),
        "sumsq_kernel": sum("sumsq_kernel" in x for x in names),
        "sumsq_finish_kernel": sum("sumsq_finish_kernel" in x for x in names),
        "adamw_kernel": sum("adamw_kernel" in x for x in names),
        **{k: sum(k in x for x in names) for k in RMS_KERNELS},
    }
    loss = float(metrics["loss"])
    log(f"[trinity] one step at B {n['batch']} T {n['seq']}, {n['n_layers']} layers, vocab "
        f"{n['vocab']}: {step_ms:.1f} ms (traced), loss {loss:.4f}; launches {launches}, "
        f"optimizer {optim_launches}, K-rms {rms_launches}; device kernels {counts} [{smi}]")
    del state, model, trainer, batch, metrics, prof
    torch.cuda.empty_cache()
    if launches != {name: n["n_layers"] for name in REPLACES}:
        fail(f"expected {n['n_layers']} launches of each kernel in a Trinity step: {launches}")
    if optim_launches != {name: 1 for name in optim.launches}:
        fail(f"expected one launch of each optimizer kernel in a Trinity step: "
             f"{optim_launches}")
    norms = 6 * n["n_layers"] + 1
    want_rms = {"rms_fwd": 2 * norms - 1, "rms_bwd": norms, "rms_bwd_finish": norms}
    if rms_launches != want_rms:
        fail(f"expected K-rms launches {want_rms} in a Trinity step: {rms_launches}")
    want = {"flash_fwd windowed": 5, "flash_fwd causal": 1, "flash_bwd_dkv windowed": 5,
            "flash_bwd_dkv causal": 1, "grouped products": 48, "sumsq_kernel": 1,
            "sumsq_finish_kernel": 1, "adamw_kernel": 1,
            **{f"rms_{k}_kernel": v for k, v in (("fwd", 2 * norms - 1), ("bwd", norms),
                                                  ("bwd_finish", norms))}}
    if counts != want or not math.isfinite(loss):
        fail(f"expected {want} device kernels in a Trinity step and a finite loss: "
             f"{counts}, {loss}")
    return {"launches": launches, "optimizer_launches": optim_launches,
            "rms_launches": rms_launches, "kernels": counts, "step_ms": step_ms}


OPTIM_CONFIGS = ("trinity-mini-l6", "mistral-7b-l8")
OPTIM_KERNELS = ("sumsq_kernel", "sumsq_finish_kernel", "adamw_kernel")


def phase_optimizer(smi: str) -> dict:
    """Phase 20: the optimizer phase at the leaves of two of the
    benchmark's configurations, kernels against the plain code and the
    library's fused AdamW. Returns per configuration its times, shares of
    the bound and launches, and the kernels' registers and spills."""
    from benchmark.families import afmoe, decoder
    from mpi_operator_tpu_torch.kernels import _build, optim
    from mpi_operator_tpu_torch.ops.trainer import global_norm

    optim.load()
    res = _build.kernel_resources(_build.build_log("optim"), OPTIM_KERNELS)
    for key in ("sumsq_kernel", "sumsq_finish_kernel", "adamw_kernel<0>", "adamw_kernel<1>"):
        if key not in res:
            fail(f"ptxas reported nothing for {key}: {sorted(res)}")
    log(f"[optimizer] ptxas: {json.dumps(res)}")
    out = {"resources": res}
    lr, max_norm, count, beta1, beta2 = 3e-4, 1.0, 10, 0.9, 0.95
    hyper = (max_norm, lr, beta1, beta2, 1 - beta1 ** count, 1 - beta2 ** count, 1e-8, 0.1)

    def update(adamw_, params, grads, opt, norm):
        adamw_({k: (p, grads[k], opt["mu"][k], opt["nu"][k]) for k, p in params.items()}, norm,
               *hyper)
    for cfg_name in OPTIM_CONFIGS:
        with open(os.path.join("benchmark", "configs", f"{cfg_name}.json")) as f:
            config = json.load(f)
        family = afmoe if config["family"] == "afmoe" else decoder
        shapes = {name: shape for name, shape, _ in family.leaves(config)}
        n = sum(math.prod(s) for s in shapes.values())
        gen = torch.Generator(device="cuda").manual_seed(20)
        params = {k: torch.randn(s, generator=gen, device="cuda") * 0.02
                  for k, s in shapes.items()}
        grads = {k: torch.randn(s, generator=gen, device="cuda") * (4.0 / n ** 0.5)
                 for k, s in shapes.items()}
        opt = {"mu": {k: (torch.randn(s, generator=gen, device="cuda") * 1e-5).to(torch.bfloat16)
                      for k, s in shapes.items()},
               "nu": {k: torch.rand(s, generator=gen, device="cuda") * 1e-10
                      for k, s in shapes.items()}}
        g_list = list(grads.values())
        with torch.no_grad():
            k_norm = global_norm(g_list)
            p_norm = torch.sqrt(optim.sum_squares_plain(g_list))
            if not abs(float(k_norm) - float(p_norm)) <= 1e-6 * float(p_norm):
                fail(f"{cfg_name}: K-norm's norm {float(k_norm)} against the plain "
                     f"{float(p_norm)}")
            # one step of each path on copies of one leaf of each shape (copies
            # of the whole state would not fit beside it), the plain norm given
            # to both: p, mu and nu bit for bit equal
            first = {}
            for k, s in shapes.items():
                first.setdefault(tuple(s), k)
            names = list(first.values())

            def copies():
                return ({k: params[k].clone() for k in names},
                        {k: grads[k].clone() for k in names},
                        {key: {k: opt[key][k].clone() for k in names} for key in opt})

            (kp, kg, kopt), (pp, pg, popt) = copies(), copies()
            update(optim.adamw_, kp, kg, kopt, p_norm)
            update(optim.adamw_plain_, pp, pg, popt, p_norm)
            unequal = {what: sum(int((a[k] != b[k]).sum()) for k in names)
                       for what, a, b in (("p", kp, pp), ("mu", kopt["mu"], popt["mu"]),
                                          ("nu", kopt["nu"], popt["nu"]))}
            log(f"[optimizer] {cfg_name}: one step over {len(names)} leaves of every shape, "
                f"{sum(kp[k].numel() for k in names)} parameters: elements that differ "
                f"from the plain path {unequal}")
            if any(unequal.values()):
                fail(f"{cfg_name}: K-adamw parts from the plain path: {unequal}")
            del kp, kg, kopt, pp, pg, popt

            def kernels():
                update(optim.adamw_, params, grads, opt, global_norm(g_list))

            optim.reset_launches()
            kernels()
            launches = dict(optim.launches)
            want = {"sumsq": len(optim.plan([g.numel() for g in g_list],
                                            optim._capacity["norm"])),
                    "sumsq_finish": 1,
                    "adamw": len(optim.plan([g.numel() for g in g_list],
                                            optim._capacity["adamw"]))}
            if launches != want:
                fail(f"{cfg_name}: planned launches {want}, counted {launches}")

            def plain():
                update(optim.adamw_plain_, params, grads, opt,
                       torch.sqrt(optim.sum_squares_plain(g_list)))

            norm = global_norm(g_list)
            leaves = {k: (params[k], grads[k], opt["mu"][k], opt["nu"][k]) for k in params}
            times = {"kernels_ms": _time_ms(kernels),
                     "k_norm_ms": _time_ms(lambda: optim.sum_squares_cuda(g_list)),
                     "k_adamw_ms": _time_ms(lambda: optim.adamw_cuda_(
                         leaves, norm, max_norm, lr, 0.9, 0.95, 0.65, 0.4, 1e-8, 0.0)),
                     "plain_ms": _time_ms(plain, reps=3)}
            del leaves, norm
            mus = list(opt["mu"].values())
            opt["mu"] = {}
            del mus
            exp_avgs = [torch.zeros_like(p) for p in params.values()]
            steps = [torch.tensor(10.0, device="cuda") for _ in params]
            p_list, nu_list = list(params.values()), list(opt["nu"].values())

            def library():
                torch._fused_adamw_(p_list, g_list, exp_avgs, nu_list, [], steps, lr=lr,
                                    beta1=0.9, beta2=0.95, weight_decay=0.0, eps=1e-8,
                                    amsgrad=False, maximize=False)

            times["library_ms"] = _time_ms(library)
        bound = {"k_norm": 1e3 * 4 * n / HBM_BYTES_PER_S,
                 "k_adamw": 1e3 * 24 * n / HBM_BYTES_PER_S}
        bound["kernels"] = bound["k_norm"] + bound["k_adamw"]
        share = {k: 100 * bound[k] / times[f"{k}_ms"] for k in bound}
        out[cfg_name] = {"leaves": len(shapes), "parameters": n, "launches": launches,
                         "norm": float(k_norm), "unequal": unequal, **times,
                         "bound_ms": bound, "share_of_bound_pct": share}
        log(f"[optimizer] {cfg_name}: {len(shapes)} leaves, {n} parameters, launches "
            f"{launches}: kernels {times['kernels_ms']:.3f} ms ({share['kernels']:.1f} % of "
            f"{bound['kernels']:.3f}), K-norm {times['k_norm_ms']:.3f} ms "
            f"({share['k_norm']:.1f} %), K-adamw {times['k_adamw_ms']:.3f} ms "
            f"({share['k_adamw']:.1f} %), plain {times['plain_ms']:.3f} ms, library "
            f"(torch._fused_adamw_, f32 moments) {times['library_ms']:.3f} ms; norm "
            f"{float(k_norm):.6f} (plain {float(p_norm):.6f}) [{smi}]")
        del params, grads, opt, exp_avgs, p_list, nu_list, g_list
        torch.cuda.empty_cache()
    return out


RMS_EPS = 1e-5
# the cells' norms: (storage shape, its permutation to the norm's view)
RMS_SHAPES = {
    "decoder [32768, 4096]": ((8, 4096, 4096), (0, 1, 2)),
    "trinity [32768, 2048]": ((4, 8192, 2048), (0, 1, 2)),
    "trinity q [4, 32, 8192, 128]": ((4, 8192, 32, 128), (0, 2, 1, 3)),
    "trinity k [4, 4, 8192, 128]": ((4, 8192, 4, 128), (0, 2, 1, 3)),
}
RMS_KERNELS = ("rms_fwd_kernel", "rms_bwd_kernel", "rms_bwd_finish_kernel")


def _device_ms(fn, flush, reps: int = 10) -> float:
    """Mean device ms a call of ``fn`` keeps the card busy, each call behind
    ``flush`` (a device-to-device copy that evicts the L2 cache): the
    kernels' own time in a ``torch.profiler`` trace, the copies left out,
    so the host's time to launch them is not counted."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    busy = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "Memcpy" not in e.name]
    if not busy:
        fail("the profiler saw no kernel on the card")
    return 1e-3 * sum(busy) / reps


def phase_rmsnorm(smi: str) -> dict:
    """Phase 21: K-rms at the cells' norms against the plain version and
    ``torch.nn.functional.rms_norm``. Returns per shape its errors, times
    and shares of the bound, and the kernels' registers and spills."""
    from mpi_operator_tpu_torch.kernels import _build
    from mpi_operator_tpu_torch.kernels import rmsnorm as krms

    krms.load()
    res = _build.kernel_resources(_build.build_log("rmsnorm"), RMS_KERNELS)
    for key in ("rms_fwd_kernel<1,4>", "rms_bwd_kernel<1,2>", "rms_bwd_finish_kernel"):
        if key not in res:
            fail(f"ptxas reported nothing for {key}: {sorted(res)}")
    log(f"[rmsnorm] ptxas: {json.dumps(res)}")
    out = {"resources": res}
    src, dst = (torch.empty(16 * 2 ** 20, dtype=torch.float32, device="cuda") for _ in "ab")
    for label, (storage, perm) in RMS_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(21)
        x = torch.randn(storage, generator=gen, device="cuda").to(torch.bfloat16).permute(perm)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
        d = x.shape[-1]
        scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        n = x.numel()
        krms.reset_launches()
        y, rstd = krms.rms_fwd_cuda(x, scale, RMS_EPS)
        dx, dscale = krms.rms_bwd_cuda(x, dy, scale, rstd)
        xl = x.detach().clone().requires_grad_(True)
        sl = scale.detach().clone().requires_grad_(True)
        y_ref = krms.rmsnorm_plain(xl, sl, RMS_EPS)
        y_ref.backward(dy)
        x32 = x.float()
        rs = torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + RMS_EPS)
        xh = x32 * rs
        g = dy.float() * scale
        size = rs * (g.abs() + xh.abs() * (g * xh).abs().sum(-1, keepdim=True) / d)
        del x32, g

        def ulp(t, bits):
            return torch.ldexp(torch.ones_like(t), torch.frexp(t.abs())[1] - bits)

        y_ref = y_ref.detach()
        y_ulps = float(((y.float() - y_ref.float()).abs()
                        / ulp(torch.maximum(y.float().abs(), y_ref.float().abs()), 8)).max())
        dx_tol = (32 * ulp(size, 24)
                  + ulp(torch.maximum(dx.float().abs(), xl.grad.float().abs()), 8))
        dx_share = float(((dx.float() - xl.grad.float()).abs() / dx_tol).max())
        magnitude = (dy.float() * xh).abs().reshape(-1, d).sum(0)
        ds_rel = float(((dscale - sl.grad).abs() / magnitude).max())
        del xh, size, dx_tol, magnitude, y_ref, xl, sl
        torch.cuda.empty_cache()
        launches = dict(krms.launches)
        errs = {"y_ulps": y_ulps, "dx_share_of_bound": dx_share, "dscale_rel": ds_rel}
        log(f"[rmsnorm] {label}: {errs}, launches {launches}")
        if y_ulps > 1.0 or dx_share > 1.0 or ds_rel > 1e-5:
            fail(f"K-rms at {label} parts from the plain version: {errs}")
        if launches != {"rms_fwd": 1, "rms_bwd": 1, "rms_bwd_finish": 1}:
            fail(f"K-rms at {label}: launches {launches}")
        def flush():  # 64 MB read and written: more than the 50 MB L2
            dst.copy_(src)

        lib_w = scale.to(torch.bfloat16)

        def plain_fwd_bwd():
            xl = x.detach().requires_grad_(True)
            sl = scale.detach().requires_grad_(True)
            krms.rmsnorm_plain(xl, sl, RMS_EPS).backward(dy)

        def library_fwd_bwd():
            xl = x.detach().requires_grad_(True)
            wl = lib_w.detach().requires_grad_(True)
            torch.nn.functional.rms_norm(xl, (d,), wl, RMS_EPS).backward(dy)

        def fwd():
            krms.rms_fwd_cuda(x, scale, RMS_EPS)

        def bwd():
            krms.rms_bwd_cuda(x, dy, scale, rstd)

        with torch.no_grad():
            times = {
                "fwd_ms": _device_ms(fwd, flush),
                "bwd_ms": _device_ms(bwd, flush),
                # launched back to back, the host's time included where it is longer
                "fwd_wall_ms": _time_ms(fwd),
                "bwd_wall_ms": _time_ms(bwd),
                "plain_fwd_ms": _device_ms(lambda: krms.rmsnorm_plain(x, scale, RMS_EPS),
                                           flush, reps=3),
                "library_fwd_ms": _device_ms(
                    lambda: torch.nn.functional.rms_norm(x, (d,), lib_w, RMS_EPS), flush),
            }
        times["plain_fwd_bwd_ms"] = _device_ms(plain_fwd_bwd, flush, reps=3)
        times["library_fwd_bwd_ms"] = _device_ms(library_fwd_bwd, flush, reps=3)
        rows = n // d
        bound = {"fwd": 1e3 * (4 * n + 4 * rows) / HBM_BYTES_PER_S,
                 "bwd": 1e3 * (6 * n + 4 * rows) / HBM_BYTES_PER_S}
        share = {k: 100 * bound[k] / times[f"{k}_ms"] for k in bound}
        out[label] = {"elements": n, "d": d, "strides": list(x.stride()), **errs, **times,
                      "bound_ms": bound, "share_of_bound_pct": share,
                      "bwd_grid": krms.bwd_grid(x.device.index, 1,
                                                *krms.launch_shape(d, 2, True), d, rows)}
        log(f"[rmsnorm] {label}: fwd {times['fwd_ms']:.4f} ms ({share['fwd']:.1f} % of "
            f"{bound['fwd']:.4f}), bwd {times['bwd_ms']:.4f} ms ({share['bwd']:.1f} % of "
            f"{bound['bwd']:.4f}); back to back with the host's time fwd "
            f"{times['fwd_wall_ms']:.4f}, bwd {times['bwd_wall_ms']:.4f} ms; plain fwd {times['plain_fwd_ms']:.3f}, fwd+bwd "
            f"{times['plain_fwd_bwd_ms']:.3f} ms; library (F.rms_norm, bf16 weight) fwd "
            f"{times['library_fwd_ms']:.4f}, fwd+bwd {times['library_fwd_bwd_ms']:.3f} ms "
            f"[{smi}]")
        del x, dy, y, rstd, dx, dscale, lib_w
        torch.cuda.empty_cache()
    del src, dst
    return out


def phase_worker_manifest(smi: str) -> dict:
    """Phase 9: the worker at examples/llama.yaml's config, tiny() as it is."""
    rc, rec, wall = _worker(MANIFEST_ENV, timeout=300)
    log(f"[worker] {MANIFEST_ENV}: rc {rc}, {wall:.1f}s, {rec} [{smi}]")
    launches = rec.get("kernel_launches", {})
    if rc != 0 or rec["backend"] != "cuda" or rec["outcome"] != "done":
        fail(f"the worker at the manifest's config failed: rc {rc}, {rec}")
    if len(rec["losses"]) != 3 or not all(math.isfinite(x) for x in rec["losses"]):
        fail(f"the worker's losses are not 3 finite values: {rec['losses']}")
    if set(launches) != set(REPLACES) or not all(launches[k] > 0 for k in REPLACES):
        fail(f"the worker launched not every kernel: {launches}")
    return rec


def phase_profiling(smi: str) -> dict:
    """Phase 10: a projected profile request for 2 steps against the worker
    with a checkpoint dir; the blob acks done and the trace shows K1."""
    from mpi_operator_tpu_torch.ops import profiling
    from mpi_operator_tpu_torch.runtime.stepstats import read_stats

    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        cfg = os.path.join(tmp, "config")
        os.makedirs(cfg)
        with open(os.path.join(cfg, profiling.PROFILE_REQUEST_FILE), "w") as f:
            json.dump({"id": "smoke", "steps": 2}, f)
        stats_path = os.path.join(tmp, "stats.json")
        env = {**MANIFEST_ENV, "LLAMA_STEPS": "6", "LLAMA_CKPT": os.path.join(tmp, "ckpt"),
               "LLAMA_SAVE_EVERY": "6", "LLAMA_CHECK_EVERY": "2", "TPUJOB_CONFIG_DIR": cfg,
               "TPUJOB_STEPSTATS_FILE": stats_path, "TPUJOB_STEPSTATS_INTERVAL": "0"}
        rc, rec, wall = _worker(env, timeout=300)
        ack = (read_stats(stats_path) or {}).get("profile", {})
        trace = os.path.join(tmp, "ckpt", "profiles", "smoke", "host0", profiling.TRACE_FILE)
        size, events = 0, []
        if os.path.exists(trace):
            size = os.path.getsize(trace)
            with open(trace) as f:
                events = json.load(f).get("traceEvents", [])
        k1 = sum(1 for e in events if CUDA_KERNEL["flash_fwd"] in e.get("name", ""))
        log(f"[profile] rc {rc}, {wall:.1f}s, ack {ack}, trace {size} bytes, {len(events)} "
            f"events, {k1} of {CUDA_KERNEL['flash_fwd']} [{smi}]")
        if rc != 0 or ack.get("state") != "done" or ack.get("id") != "smoke":
            fail(f"the profile request was not served: rc {rc}, ack {ack}")
        if not k1:
            fail(f"the trace ({size} bytes) holds no {CUDA_KERNEL['flash_fwd']} event")
        return {"ack": ack, "trace_bytes": size, "events": len(events), "k1_events": k1}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_compile_cache(smi: str) -> dict:
    """Phase 11: two processes on one fresh kernel-cache dir."""
    from mpi_operator_tpu_torch.runtime import compile_cache

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    try:
        out = compile_cache.smoke(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[cache] {out} [{smi}]")
    if not out["ok"]:
        fail(f"the second process did not load the first one's kernels without nvcc: {out}")
    return out


def phase_moe_pipeline(smi: str) -> dict:
    """Phase 12: the MoE layer at the bench widths, timed, and on 512 tokens
    against the CPU; run_pipeline's fall-back on the card against the CPU."""
    from mpi_operator_tpu_torch.parallel import moe
    from mpi_operator_tpu_torch.parallel.pipeline import run_pipeline

    cfg = moe.MoEConfig(d_model=2048, d_ff=7168, n_experts=8)
    params = moe.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    leaves = [params[g]["w"].requires_grad_() for g in ("router", "w_in", "w_out")]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(4, 2048, 2048, generator=gen, device="cuda").to(torch.bfloat16)

    def fwd():
        with torch.no_grad():
            return moe.apply(cfg, params, x)

    def fwd_bwd():
        y, aux = moe.apply(cfg, params, x)
        return torch.autograd.grad((y.float() ** 2).mean() + 0.01 * aux, leaves)

    fwd_ms, fwd_bwd_ms = _time_ms(fwd, reps=5), _time_ms(fwd_bwd, reps=5)
    y, aux = fwd()
    if not (bool(torch.isfinite(y).all()) and math.isfinite(float(aux))):
        fail("the MoE layer's output is not finite at the bench widths")
    log(f"[moe] d_model 2048, d_ff 7168, 8 experts, 4 x 2048 tokens bf16: forward "
        f"{fwd_ms:.3f} ms, forward + backward {fwd_bwd_ms:.3f} ms, aux {float(aux):.4f} [{smi}]")

    xs = x[:1, :512]
    res = {}
    for dev in ("cuda", "cpu"):
        p = {g: {"w": params[g]["w"].detach().to(dev).requires_grad_()} for g in params}
        y, aux = moe.apply(cfg, p, xs.to(dev))
        grads = torch.autograd.grad((y.float() ** 2).mean() + 0.01 * aux,
                                    [p[g]["w"] for g in ("router", "w_in", "w_out")])
        res[dev] = (y.detach().float().cpu(), float(aux.detach()),
                    [g.float().cpu() for g in grads])
    (y_c, aux_c, g_c), (y_h, aux_h, g_h) = res["cuda"], res["cpu"]
    errs = {"y": _max_err(y_c, y_h) / float(y_h.abs().max())}
    errs.update({f"grad_{g}": _max_err(a, b) / float(b.abs().max())
                 for g, a, b in zip(("router", "w_in", "w_out"), g_c, g_h)})
    log(f"[moe] 512 tokens, card against the CPU: {errs} (bound 3e-2 of max), aux "
        f"{aux_c:.6f} / {aux_h:.6f}")
    if not (all(e <= 3e-2 for e in errs.values()) and abs(aux_c - aux_h) <= 1e-4 * aux_h):
        fail(f"the MoE layer on the card disagrees with the CPU: {errs}, aux {aux_c} {aux_h}")

    d, n_layers = 512, 8
    stacked = {"w": torch.randn(n_layers, d, d, generator=gen, device="cuda") * d ** -0.5,
               "b": torch.zeros(n_layers, d, device="cuda")}
    h = torch.randn(64, d, generator=gen, device="cuda")

    def stage(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    got = run_pipeline(stage, stacked, h, None, n_microbatches=4).cpu()
    want = run_pipeline(stage, {k: v.cpu() for k, v in stacked.items()}, h.cpu(), None,
                        n_microbatches=4)
    e_pipe = _max_err(got, want) / float(want.abs().max())
    log(f"[pipeline] fall-back (no pipe axis), {n_layers} layers of {d}: card against the "
        f"CPU {e_pipe:.3e} (bound 1e-5)")
    if not e_pipe <= 1e-5:
        fail(f"run_pipeline's fall-back on the card disagrees with the CPU: {e_pipe}")
    return {"fwd_ms": fwd_ms, "fwd_bwd_ms": fwd_bwd_ms, "errs": errs, "pipe_err": e_pipe}


def _quant_bound(m: int, k: int, n: int, precision: str):
    """(least ms, what bounds it) of one quantized product: its 1-byte
    operands read and its 4-byte accumulator written once against the
    card's memory rate, or 2·M·K·N operations at the type's peak."""
    bytes_ms = 1e3 * (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2 * m * k * n / QUANT_OPS_PER_S[precision]
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_quant(smi: str) -> list:
    """Phase 13 (see the module docstring). Returns one record per
    precision and shape."""
    from mpi_operator_tpu_torch.kernels import quant_matmul as qm

    out = []
    gen = torch.Generator(device="cuda").manual_seed(13)
    for m, k, n in FFN_SHAPES:
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
        bf16_ms = _time_ms(lambda: x @ w)
        for precision in ("int8", "fp8"):
            qm.reset_launches()
            got = qm.forward_2d(x, w, precision)
            torch.cuda.synchronize()
            if qm.launches[precision] != 1:
                fail(f"the {precision} product was not launched on the card: {qm.launches}")
            want = qm.forward_2d(x.cpu(), w.cpu(), precision)
            err = _max_err(got.cpu(), want) / float(want.float().abs().max())
            # fp8: the f32 sums round in another order, so a bf16 output may
            # round the other way: one bf16 ulp of the value (2^-7 of it at
            # most) beside 1e-3 of max for the sums near zero
            slack = (got.cpu().float() - want.float()).abs() - 2 ** -7 * want.float().abs()
            bound_err = 0.0 if precision == "int8" else 1e-3
            if precision == "fp8":
                err = float(slack.max()) / float(want.float().abs().max())
            qerr = qm.quant_error(x, w, precision=precision)
            x32, w32 = x.float(), w.float()
            qmax = qm._QMAX[precision]
            xq = qm._quantize(x32, qm._scale(x32, -1, qmax), precision)
            wq = qm._quantize(w32, qm._scale(w32, 0, qmax), precision)
            prod_ms = _time_ms(lambda: qm.product_cuda(xq, wq, precision))
            fwd_ms = _time_ms(lambda: qm.forward_2d(x, w, precision))
            plain_ms = _time_ms(lambda: xq.float() @ wq.float(), reps=3)
            bound_ms, bound_by = _quant_bound(m, k, n, precision)
            rec = dict(precision=precision, m=m, k=k, n=n, max_rel_err=err, quant_error=qerr,
                       product_ms=prod_ms, forward_ms=fwd_ms, bf16_matmul_ms=bf16_ms,
                       plain_f32_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            log(f"[quant] {precision} [{m}x{k}] @ [{k}x{n}]: card vs plain {err:.3e} of max "
                f"{'beyond one bf16 ulp ' if precision == 'fp8' else ''}(bound {bound_err:.0e}), "
                f"quant_error {qerr:.4f}; product {prod_ms:.4f} ms "
                f"({100 * bound_ms / prod_ms:.1f} % of its {bound_by} bound {bound_ms:.4f} ms), "
                f"whole forward (scales, quantize, product, epilogue) {fwd_ms:.4f} ms, bf16 "
                f"matmul {bf16_ms:.4f} ms, f32 product of the quantized values {plain_ms:.3f} "
                f"ms [{smi}]")
            if not err <= bound_err:
                fail(f"the {precision} product disagrees with its plain version: {err}")
            if not qerr < (0.02 if precision == "int8" else 0.06):
                fail(f"the {precision} product's quant_error is {qerr}")
            out.append(rec)
            del got, want, xq, wq, x32, w32
        del x, w
        torch.cuda.empty_cache()
    return out


def phase_quant_bench(smi: str, bf16_first_loss: float) -> dict:
    """Phase 14: the Llama bench with quantized FFN products."""
    from mpi_operator_tpu_torch import bench
    from mpi_operator_tpu_torch.kernels import flash_attention as fa

    out = {}
    steps, warmup = 3, 1
    for precision in ("int8", "fp8"):
        fa.reset_launches()
        rec = bench.bench_llama(seq_len=2048, per_chip_batch=4, steps=steps, warmup=warmup,
                                device="cuda", check_kernel=False, quant=precision)
        launches, losses = dict(fa.launches), rec["losses"]
        log(f"[quant-bench] {precision}: losses {losses}, step_ms {rec['step_ms']:.2f}, "
            f"tokens/s {rec['value']:.1f}, mfu (bf16 peak) {rec['mfu']:.4f}, "
            f"max_memory_allocated {rec['max_memory_allocated']}, flash launches {launches}, "
            f"quantized products {rec['quant_launches']} [{smi}]")
        n = warmup + steps
        if rec["matmul_precision"] != precision or len(losses) != n:
            fail(f"the {precision} bench did not run as asked: {rec}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"non-finite {precision} loss: {losses}")
        if not abs(losses[0] - bf16_first_loss) <= 0.05 * bf16_first_loss:
            fail(f"the {precision} first loss {losses[0]} is not within 5 % of bf16's "
                 f"{bf16_first_loss}")
        if launches != {name: 12 * n for name in REPLACES}:
            fail(f"expected {12 * n} launches of each kernel at {precision}, got {launches}")
        if rec["quant_launches"][precision] != 6 * 12 * n:
            fail(f"expected {6 * 12 * n} {precision} products, got {rec['quant_launches']}")
        out[precision] = rec
    return out


def phase_resnet(smi: str) -> dict:
    """Phase 15: the small ResNet on the card against the CPU, then the
    ResNet-101 bench, streamed and fixed."""
    from mpi_operator_tpu_torch import bench
    from mpi_operator_tpu_torch.models import resnet
    from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_imagenet
    from mpi_operator_tpu_torch.ops.trainer import global_norm

    cfg = resnet.Config(depth="resnet26", image_size=64, num_classes=10)
    host = next(synthetic_imagenet(global_batch=8, image_size=64, num_classes=10,
                                   process_index=0, process_count=1))
    base = resnet.init(cfg, torch.Generator().manual_seed(0), "cpu")
    res = {}
    for dev in ("cuda", "cpu"):
        model = resnet.ResNet(cfg, device=dev)
        model.load_state_dict(base.state_dict())
        loss = resnet.loss_fn(model, make_global_batch(host, dev))
        loss.backward()
        res[dev] = (loss.item(), global_norm([p.grad for p in model.parameters()]).item())
    (l_gpu, g_gpu), (l_cpu, g_cpu) = res["cuda"], res["cpu"]
    log(f"[resnet] resnet26 image 64 batch 8 bf16: loss cuda {l_gpu:.6f} cpu {l_cpu:.6f}; "
        f"grad norm cuda {g_gpu:.6f} cpu {g_cpu:.6f}")
    if not (abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu) and abs(g_gpu - g_cpu) <= 5e-2 * g_cpu):
        fail("the small ResNet on the card disagrees with its CPU reference")
    del model, base
    out = {"reference": res}
    for mode, warmup in (("stream", None), ("fixed", 2)):
        torch.cuda.empty_cache()
        rec = bench.bench_resnet(input_mode=mode, warmup=warmup, device="cuda")
        log(f"[resnet] bench {rec['model']} {rec['image_size']} px batch {rec['global_batch']} "
            f"input {mode}: {rec['value']:.2f} images/s ({rec['vs_baseline']:.3f} x 154.2), "
            f"step_ms {rec['step_ms']:.2f}, mfu {rec['mfu']:.4f}, setup_s {rec['setup_s']:.2f}, "
            f"warmup_s {rec['warmup_s']:.2f}, max_memory_allocated "
            f"{rec['max_memory_allocated']}, last losses {rec['losses'][-3:]} [{smi}]")
        if (rec["model"], rec["image_size"], rec["global_batch"]) != ("resnet101", 224, 128):
            fail(f"the ResNet bench did not run at full width: {rec}")
        if not all(math.isfinite(x) for x in rec["losses"]):
            fail(f"non-finite ResNet loss ({mode}): {rec['losses']}")
        out[mode] = rec
    log(f"[resnet] stream against fixed: {out['stream']['step_ms']:.2f} / "
        f"{out['fixed']['step_ms']:.2f} ms a step "
        f"({out['stream']['step_ms'] / out['fixed']['step_ms']:.3f}) [{smi}]")
    return out


def phase_workers(smi: str) -> dict:
    """Phase 16: the ResNet, MNIST and π workers as the operator launches
    them, one rank each, on the card."""
    out = {}
    rc, line, wall = _run_worker("resnet_worker", {**ONE_RANK_ENV, **RESNET_MANIFEST_ENV}, 300)
    log(f"[workers] resnet_worker {RESNET_MANIFEST_ENV}: rc {rc}, {wall:.1f}s, {line} [{smi}]")
    rec = json.loads(line) if line.startswith("{") else {}
    if rc != 0 or rec.get("backend") != "cuda" or not math.isfinite(rec.get("loss", math.nan)):
        fail(f"the ResNet worker failed on the card: rc {rc}, {line}")
    out["resnet"] = rec
    rc, line, wall = _run_worker("mnist_worker", ONE_RANK_ENV, 300, ("20",))
    log(f"[workers] mnist_worker 20 steps: rc {rc}, {wall:.1f}s, {line} [{smi}]")
    if rc != 0 or not line.startswith("mnist: loss"):
        fail(f"the MNIST worker failed on the card: rc {rc}, {line}")
    out["mnist"] = line
    rc, line, wall = _run_worker("pi_worker", ONE_RANK_ENV, 300, ("200000",))
    log(f"[workers] pi_worker 200000 points: rc {rc}, {wall:.1f}s, {line} [{smi}]")
    try:
        pi = float(line.split("pi is approximately ")[1].split()[0])
    except (IndexError, ValueError):
        fail(f"the pi worker printed no estimate: rc {rc}, {line}")
    # within 5 standard errors of π: 4·sqrt(p(1 - p)/n), p = π/4
    p = math.pi / 4
    if rc != 0 or not abs(pi - math.pi) <= 5 * 4 * math.sqrt(p * (1 - p) / 200_000):
        fail(f"the pi worker's estimate is off: rc {rc}, {line}")
    out["pi"] = pi
    return out


def main() -> None:
    smi = phase_device()
    resources = phase_build()
    errs = phase_kernels()
    times = phase_timing(smi)
    long_errs = phase_long(smi)
    long_times = phase_timing(smi, LONG_SHAPE, plain=False)
    phase_reference()
    launches, bf16_first_loss = phase_main(smi)
    phase_gang(smi)
    ring = phase_ring(smi)
    small_d = phase_small_d(smi)
    phase_worker_manifest(smi)
    phase_profiling(smi)
    phase_compile_cache(smi)
    phase_moe_pipeline(smi)
    quant = phase_quant(smi)
    phase_quant_bench(smi, bf16_first_loss)
    phase_resnet(smi)
    phase_workers(smi)
    window = phase_window(smi)
    grouped = phase_grouped(smi)
    phase_trinity_step(smi)
    optimizer = phase_optimizer(smi)
    rms = phase_rmsnorm(smi)
    log(json.dumps({"library_products": quant, "window": window, "grouped_mm": grouped,
                    "optimizer": optimizer, "rmsnorm": rms}))
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": CU_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "ring_launches": ring["launches"][name],
            **ring["times"][name],
            "max_abs_err": errs[name],
            **times[name],
            "long": {**long_times[name], **({"max_abs_err": long_errs[name]}
                                             if name in long_errs else {})},
            **resources[name],
            "small_d": small_d[name],
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
