"""Quantized matmul: int8 / fp8 forward, full-precision backward.

Port of ``mpi_operator_tpu/kernels/quant_matmul.py``, the seam the Llama
FFN products (``w_gate``, ``w_up``, ``w_down``) run through when
``Config.matmul_precision`` is "int8" or "fp8". The same arithmetic:

- scales from the absmax of each row of x and each column of w, floored at
  1e-12 (an all-zero row quantizes to zeros), over the grid's maximum (127
  for int8, 448 for fp8 e4m3);
- int8: ``round`` (half to even), clip to ±127, int8; fp8: f32 →
  ``float8_e4m3fn``;
- the product accumulates in int32 (int8) or f32 (fp8), then
  ``acc.float() * sx * sw`` in f32 and a cast to x's dtype;
- the backward is the straight-through estimator: ``dx = g @ wᵀ`` and
  ``dw = xᵀ @ g`` at full precision, with the JAX package's casts.

The product is a library call, as ``lax.dot_general`` is in the JAX package
(no Pallas kernel there): on the card ``torch._int_mm`` (cuBLASLt int8 →
int32) and ``torch._scaled_mm`` (e4m3 with unit scales, f32 out; the
epilogue applies the scales in the JAX package's order). Both take their
second operand column-major. ``_int_mm`` wants more than 16 rows, so fewer
are padded with zero rows (they quantize to zeros) and sliced off. On the
CPU the plain versions run: ``torch._int_mm`` (exact) and an f32 product of
the e4m3 values. A failed library call raises; nothing falls back to a
bf16 product.

Under ``tensor`` (``tp_group``) the product is row-parallel, as ``w_down``
is in models/llama.py: x and w hold this rank's block of K. The JAX
package's global view takes each absmax over the whole K, so the row
scales of x and the column scales of w are MAX all-reduced over the group
before quantizing, and the accumulators are summed over it (int32 sums are
exact) before the epilogue. The backward communicates nothing: the output
gradient is whole on every rank, as after ``reduce_from_tp``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mpi_operator_tpu_torch.parallel.collectives import reduce_from_tp

# quantization grids: int8 symmetric [-127, 127]; fp8 e4m3 saturates at 448
_QMAX = {"int8": 127.0, "fp8": 448.0}
_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes M > 16

# Library products per precision on the card (the CPU's plain products are
# not counted); ``reset_launches`` zeroes them.
launches = {"int8": 0, "fp8": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _scale(a32: torch.Tensor, dim: int, qmax: float, group=None) -> torch.Tensor:
    """Per-slice absmax over ``dim`` (MAX all-reduced over ``group``), as a
    multiply-by-scale dequant factor."""
    m = a32.abs().amax(dim, keepdim=True)
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    # a true division, as XLA's: on CUDA, dividing by a Python scalar
    # multiplies by its reciprocal, one ulp off, and flips roundings
    return m.clamp_min(1e-12) / torch.full((), qmax, device=m.device)


def _quantize(a32: torch.Tensor, scale: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "int8":
        return torch.clamp(torch.round(a32 / scale), -127.0, 127.0).to(torch.int8)
    return (a32 / scale).to(torch.float8_e4m3fn)


def product_plain(xq: torch.Tensor, wq: torch.Tensor, precision: str) -> torch.Tensor:
    """The quantized product's plain version: int32 (int8) or f32 (fp8)."""
    if precision == "int8":
        return torch._int_mm(xq, wq)
    return xq.float() @ wq.float()


def product_cuda(xq: torch.Tensor, wq: torch.Tensor, precision: str) -> torch.Tensor:
    """The quantized product on the card: ``torch._int_mm`` (int32 out) or
    ``torch._scaled_mm`` with unit scales (f32 out)."""
    w_cm = wq.t().contiguous().t()  # column-major, as cuBLASLt's int8 and fp8 paths take it
    if precision == "int8":
        m = xq.shape[0]
        if m < _INT_MM_MIN_ROWS:
            xq = torch.cat([xq, xq.new_zeros(_INT_MM_MIN_ROWS - m, xq.shape[1])])
        acc = torch._int_mm(xq.contiguous(), w_cm)[:m]
    else:
        one = torch.ones((), dtype=torch.float32, device=xq.device)
        acc = torch._scaled_mm(xq.contiguous(), w_cm, scale_a=one, scale_b=one,
                               out_dtype=torch.float32)
    launches[precision] += 1
    return acc


def _product(xq, wq, precision: str) -> torch.Tensor:
    if xq.device.type == "cuda":
        return product_cuda(xq, wq, precision)
    if xq.device.type == "cpu":
        return product_plain(xq, wq, precision)
    raise ValueError(f"quant_matmul runs on cuda or cpu tensors, not {xq.device.type}")


def forward_2d(x: torch.Tensor, w: torch.Tensor, precision: str, group=None) -> torch.Tensor:
    """x [M, K] @ w [K, N] with the contraction quantized to ``precision``
    (over ``group``, K is this rank's block of it)."""
    qmax = _QMAX[precision]
    x32, w32 = x.float(), w.float()
    sx = _scale(x32, -1, qmax, group)  # [M, 1], per activation row
    sw = _scale(w32, 0, qmax, group)   # [1, N], per weight column
    acc = _product(_quantize(x32, sx, precision), _quantize(w32, sw, precision), precision)
    if group is not None:
        dist.all_reduce(acc, group=group)
    return (acc.float() * sx * sw).to(x.dtype)


class _QuantMM(torch.autograd.Function):
    """The quantized forward with the straight-through backward."""

    @staticmethod
    def forward(ctx, x, w, precision, group):
        ctx.save_for_backward(x, w)
        return forward_2d(x, w, precision, group)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = (g @ w.t().to(g.dtype)).to(x.dtype)
        dw = (x.t().to(g.dtype) @ g).to(w.dtype)
        return dx, dw, None, None


def quant_matmul(
    x: torch.Tensor, w: torch.Tensor, *, precision: str = "int8", tp_group=None
) -> torch.Tensor:
    """``x @ w`` with the contraction quantized to ``precision``.

    ``x``: [..., K] (leading dims flattened for the 2D product and restored
    after); ``w``: [K, N]. ``precision`` ∈ {"int8", "fp8", "bf16"}: "bf16"
    is the identity escape hatch, so call sites pass the config flag
    through. ``tp_group``: K is split over it (the row-parallel product);
    the result is then the sum over the group, on every rank."""
    if precision == "bf16":
        return reduce_from_tp(x @ w, tp_group)
    if precision not in _QMAX:
        raise ValueError(f"precision={precision!r}; expected int8|fp8|bf16")
    lead = x.shape[:-1]
    out = _QuantMM.apply(x.reshape(-1, x.shape[-1]), w, precision, tp_group)
    return out.reshape(*lead, w.shape[-1])


def quant_error(x: torch.Tensor, w: torch.Tensor, *, precision: str = "int8") -> float:
    """Relative Frobenius error of the quantized product against the f32
    product."""
    exact = x.float() @ w.float()
    with torch.no_grad():
        approx = quant_matmul(x, w, precision=precision).float()
    return float(torch.linalg.norm(approx - exact) / torch.linalg.norm(exact).clamp_min(1e-12))

