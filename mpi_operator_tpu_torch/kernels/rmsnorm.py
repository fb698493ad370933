"""RMSNorm, the models' (``models/llama._rmsnorm``, which ``models/afmoe``
calls for all its norms, QK-norm included), as hand-written CUDA kernels
(``csrc/rmsnorm.cu``, K-rms) beside its plain PyTorch version.

- ``rms_fwd`` (:func:`rms_fwd_cuda`): per row rstd = rsqrt(mean(x²) + eps)
  and y = (x · rstd) · scale in f32, rounded once to x's dtype; rstd (f32,
  a row) is kept for the backward;
- ``rms_bwd`` + ``rms_bwd_finish`` (:func:`rms_bwd_cuda`): dx = rstd · (g −
  x̂ · mean(g · x̂)) with x̂ = x · rstd and g = dy · scale, in f32, rounded
  once; the scale's gradient Σ_rows dy · x̂ as one f32 partial a CTA of a
  persistent grid, which the finishing kernel adds in a fixed order.

A row is read once into registers: ~14 bytes an element a training step
(the forward twice under the layer's recompute) where the eager passes of
:func:`rmsnorm_plain` move ~184.

:func:`rmsnorm` chooses by the device of ``x``, as flash attention and the
optimizer do: CUDA tensors go to the kernels (an autograd Function whose
backward is ``rms_bwd``), any others to :func:`rmsnorm_plain`. Nothing falls
back: what the kernels cannot take they refuse with a ``ValueError`` that
names it, before anything is launched or loaded. They take x in bf16 or f32
whose last dimension D (a multiple of 8, at most ``MAX_D``) has stride 1,
whose rows start 16-byte aligned and do not overlap, addressed by at most
three leading indices once the leading dimensions that can be merged are
(:func:`row_plan`), and an f32 scale of D contiguous values; the backward
holds dy to the same rules, each operand with strides of its own, after
:func:`dense_rows` has made a broadcast dy (stride 0) contiguous. The
output has x's strides (``empty_like``), so heads-major q and k that are a
view of [B, T, H, Dh] storage go in and come out with no copy.

:func:`launch_shape` adapts the launch to D: several rows a warp at QK-norm's
128 (and the tiny configurations' 16 and 64), one or more warps a row at
2048 and 4096. ``launches`` counts the launches of each kernel, and
``reset_launches`` zeroes them. The library builds at its first use (a
model's first step, in set-up).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from mpi_operator_tpu_torch.kernels import _build

MAX_D = 8192  # the widest row: csrc/rmsnorm.cu's kMaxD
BLOCK = 256  # threads of a CTA: csrc/rmsnorm.cu's kBlock
VECTOR_BYTES = 16  # a thread's loads and stores
MAX_ROWS = 2 ** 30
_DTYPES = (torch.bfloat16, torch.float32)

_lib = None
launches = {"rms_fwd": 0, "rms_bwd": 0, "rms_bwd_finish": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def load():
    """The library, built at its first use in a build directory and loaded
    once. A build or load failure raises."""
    global _lib
    if _lib is None:
        i64, vp, i, f = ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p, ctypes.c_int, \
            ctypes.c_float
        lib = _build.typed_library("rmsnorm", {
            "tpujob_rms_limits": [i],
            "tpujob_rms_fwd": [vp, i64, vp, i64, vp, vp, i, i, i, i, i, i, i, f, f, vp],
            "tpujob_rms_bwd_grid": [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)],
            "tpujob_rms_bwd": [vp, i64, vp, i64, vp, i64, vp, vp, vp, i, i, i, i, i, i, i, i,
                               f, vp],
            "tpujob_rms_bwd_finish": [vp, i, i, vp, vp],
        }, "tpujob_rms_error_string")
        limits = (lib.tpujob_rms_limits(0), lib.tpujob_rms_limits(1))
        if limits != (MAX_D, BLOCK):
            raise RuntimeError(f"csrc/rmsnorm.cu takes rows up to {limits[0]} in CTAs of "
                               f"{limits[1]}; kernels/rmsnorm.py plans {MAX_D} and {BLOCK}")
        _lib = lib
    return _lib


def rmsnorm_plain(x, scale, eps: float):
    """K-rms's plain version, on any device: RMSNorm in f32 with an f32
    scale, cast back to x's dtype (autograd differentiates it)."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def rmsnorm(x, scale, eps: float):
    """RMSNorm over the last dimension of ``x``, times ``scale``:
    differentiable; K-rms for CUDA tensors, :func:`rmsnorm_plain` for any
    others."""
    if x.is_cuda:
        return _RMSNorm.apply(x, scale, float(eps))
    return rmsnorm_plain(x, scale, eps)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        y, rstd = rms_fwd_cuda(x, scale, eps)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rms_bwd_cuda(x, dense_rows(dy), scale, rstd)
        return dx, dscale, None


def dense_rows(dy: torch.Tensor) -> torch.Tensor:
    """``dy`` itself, or a contiguous copy where a dimension of it is a
    broadcast (stride 0 over more than one index, as autograd hands the
    gradient of ``y.sum()``), whose rows overlap and which the backward
    kernel does not take: a change of layout, made once a call."""
    if any(s == 0 and n > 1 for n, s in zip(dy.shape, dy.stride())):
        return dy.contiguous()
    return dy


def launch_shape(d: int, itemsize: int, backward: bool) -> Tuple[int, int]:
    """(16-byte vectors a thread holds, threads a row) for rows of ``d``
    elements of ``itemsize`` bytes: 4 vectors a thread forward, 2 backward
    (which holds x̂, g and the scale's sums), more where a row would take
    more than a CTA; the threads a row the least power of 2 that covers it."""
    nvec = d * itemsize // VECTOR_BYTES
    vpt = 2 if backward else 4
    while vpt > 1 and vpt // 2 >= nvec:
        vpt //= 2
    while nvec > vpt * BLOCK:
        vpt *= 2
    need = -(-nvec // vpt)
    return vpt, 1 << (need - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """Rows as the kernels address them: ``rows`` rows of ``d`` elements,
    row r at (i0, i1, i2) = (r // (n1 n2), r // n2 % n1, r % n2), and per
    operand its three leading strides in elements."""
    rows: int
    n1: int
    n2: int
    d: int
    strides: Mapping[str, Tuple[int, int, int]]


def row_plan(shape, operands: Mapping[str, Tuple[Tuple[int, ...], int, int]]) -> RowPlan:
    """The rows of tensors of one ``shape``, given each operand's (strides,
    data pointer, element size) by name: the leading dimensions of size 1
    dropped, neighbours merged where every operand's strides allow, at most
    three left. Refuses with a ``ValueError`` that names the operand a last
    dimension that is not a multiple of 8 in 8..``MAX_D`` or whose stride is
    not 1, a row that does not start 16-byte aligned, rows that overlap, and
    more than three leading dimensions or ``MAX_ROWS`` rows."""
    return _row_plan(tuple(int(n) for n in shape),
                     tuple((name, tuple(strides), ptr % VECTOR_BYTES, itemsize)
                           for name, (strides, ptr, itemsize) in operands.items()))


@functools.lru_cache(maxsize=256)
def _row_plan(shape, operands) -> RowPlan:
    """:func:`row_plan` of operands (name, strides, address mod 16, element
    size), once a layout: a step's norms repeat a few layouts."""
    if not shape:
        raise ValueError("K-rms takes a tensor of at least one dimension, got a 0-d one")
    d = shape[-1]
    if d % 8 or not 8 <= d <= MAX_D:
        raise ValueError(f"K-rms takes a last dimension D that is a multiple of 8 from 8 to "
                         f"{MAX_D}, got D={d}")
    for name, strides, misaligned, itemsize in operands:
        if strides[-1] != 1:
            raise ValueError(f"K-rms takes {name} with stride 1 in its last dimension, got "
                             f"strides {strides}")
        lead = [(n, s) for n, s in zip(shape[:-1], strides[:-1]) if n > 1]
        if misaligned or any(s * itemsize % VECTOR_BYTES for _, s in lead):
            raise ValueError(f"K-rms takes {name} with every row 16-byte aligned, got an "
                             f"address {misaligned} bytes past a 16-byte boundary and strides "
                             f"{strides} of {itemsize}-byte elements")
        extent = d
        for n, s in sorted(lead, key=lambda ns: ns[1]):
            if s < extent:
                raise ValueError(f"K-rms takes {name} with rows that do not overlap, got shape "
                                 f"{shape} and strides {strides}")
            extent = s * (n - 1) + extent
    rows = int(np.prod(shape[:-1], dtype=np.int64))
    if rows >= MAX_ROWS:
        raise ValueError(f"K-rms takes fewer than {MAX_ROWS} rows, got {rows}")
    names = [op[0] for op in operands]
    dims = [(n, [op[1][i] for op in operands]) for i, n in enumerate(shape[:-1]) if n > 1]
    merged = []
    for n, st in dims:
        if merged and all(a == b * n for a, b in zip(merged[-1][1], st)):
            merged[-1] = (merged[-1][0] * n, st)
        else:
            merged.append((n, st))
    if len(merged) > 3:
        raise ValueError(f"K-rms addresses rows by at most three leading dimensions; "
                         f"{', '.join(names)} of shape {shape} and strides "
                         f"{[op[1] for op in operands]} keep {len(merged)}")
    merged = [(1, [0] * len(names))] * (3 - len(merged)) + merged
    return RowPlan(rows=rows, n1=merged[1][0], n2=merged[2][0], d=d,
                   strides={k: tuple(m[1][i] for m in merged) for i, k in enumerate(names)})


def _operands(**tensors) -> Dict[str, Tuple[Tuple[int, ...], int, int]]:
    return {name: (t.stride(), t.data_ptr(), t.element_size()) for name, t in tensors.items()}


def _check(x, scale) -> None:
    """The refusals of both kernels that need no layout or device: x's
    dtype and the scale."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"K-rms takes x in bf16 or f32, got {x.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (d,)
            or scale.stride() != (1,) or scale.data_ptr() % VECTOR_BYTES):
        raise ValueError(f"K-rms takes a contiguous, 16-byte aligned f32 scale of {d} "
                         f"values, got {scale.dtype} {tuple(scale.shape)} strides "
                         f"{scale.stride()}")


def _on_card(x, scale) -> None:
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"K-rms takes x and scale on one CUDA device, got {x.device} and "
                         f"{scale.device}")


def _inv(d: int) -> float:
    """1 / d in f32, as PyTorch's mean multiplies a sum by it."""
    return float(np.float32(1.0) / np.float32(d))


def _strides(plan: RowPlan, name: str):
    return (ctypes.c_longlong * 3)(*plan.strides[name])


def rms_fwd_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """K-rms's forward: (y, rstd), y of x's dtype and strides, rstd [rows]
    f32 in row order. Refuses with a ``ValueError``, before loading or
    launching anything, what :func:`row_plan` and the kernels cannot take."""
    _check(x, scale)
    y = torch.empty_like(x)
    plan = row_plan(x.shape, _operands(x=x, y=y))
    _on_card(x, scale)
    rstd = torch.empty(plan.rows, dtype=torch.float32, device=x.device)
    if plan.rows == 0:
        return y, rstd
    lib = load()
    vpt, tpr = launch_shape(plan.d, x.element_size(), backward=False)
    with torch.cuda.device(x.device):
        rc = lib.tpujob_rms_fwd(
            x.data_ptr(), _strides(plan, "x"), y.data_ptr(), _strides(plan, "y"),
            scale.data_ptr(), rstd.data_ptr(), int(x.dtype == torch.bfloat16), plan.rows,
            plan.n1, plan.n2, plan.d, vpt, tpr, _inv(plan.d), float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "rms_fwd_kernel")
    launches["rms_fwd"] += 1
    return y, rstd


@functools.lru_cache(maxsize=64)
def bwd_grid(device: int, bf16: int, vpt: int, tpr: int, d: int, rows: int) -> int:
    """The backward's persistent grid on CUDA device ``device``: the CTAs
    the card holds at once at this launch shape, or fewer if the rows need
    fewer (asked of the card once a shape)."""
    lib = load()
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.tpujob_rms_bwd_grid(bf16, vpt, tpr, d, rows, ctypes.byref(out))
    _build.check(lib, rc, "rms_bwd grid")
    return out.value


def rms_bwd_cuda(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                 rstd: torch.Tensor):
    """K-rms's backward: (dx of x's dtype and strides, dscale [D] f32) from
    the forward's x, scale and rstd. Refuses with a ``ValueError``, before
    loading or launching anything, what the kernels cannot take, dy
    included."""
    _check(x, scale)
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"K-rms takes dy of x's dtype and shape {x.dtype} "
                         f"{tuple(x.shape)}, got {dy.dtype} {tuple(dy.shape)}")
    dx = torch.empty_like(x)
    plan = row_plan(x.shape, _operands(x=x, dy=dy, dx=dx))
    if rstd.dtype != torch.float32 or tuple(rstd.shape) != (plan.rows,) or \
            not rstd.is_contiguous():
        raise ValueError(f"K-rms takes the forward's rstd, {plan.rows} contiguous f32 values, "
                         f"got {rstd.dtype} {tuple(rstd.shape)}")
    _on_card(x, scale)
    if dy.device != x.device or rstd.device != x.device:
        raise ValueError(f"K-rms takes dy and rstd on x's device {x.device}, got {dy.device} "
                         f"and {rstd.device}")
    if plan.rows == 0:
        return dx, torch.zeros_like(scale)
    lib = load()
    bf16 = int(x.dtype == torch.bfloat16)
    vpt, tpr = launch_shape(plan.d, x.element_size(), backward=True)
    grid = bwd_grid(x.device.index, bf16, vpt, tpr, plan.d, plan.rows)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        partials = torch.empty(grid, plan.d, dtype=torch.float32, device=x.device)
        rc = lib.tpujob_rms_bwd(
            x.data_ptr(), _strides(plan, "x"), dy.data_ptr(), _strides(plan, "dy"),
            dx.data_ptr(), _strides(plan, "dx"), scale.data_ptr(), rstd.data_ptr(),
            partials.data_ptr(), bf16, plan.rows, plan.n1, plan.n2, plan.d, vpt, tpr, grid,
            _inv(plan.d), stream)
        _build.check(lib, rc, "rms_bwd_kernel")
        launches["rms_bwd"] += 1
        dscale = torch.empty_like(scale)
        rc = lib.tpujob_rms_bwd_finish(partials.data_ptr(), grid, plan.d, dscale.data_ptr(),
                                       stream)
        _build.check(lib, rc, "rms_bwd_finish_kernel")
        launches["rms_bwd_finish"] += 1
    return dx, dscale

