"""The optimizer phase's hand-written CUDA kernels (``csrc/optim.cu``): the
clip's sum of squares and the clip's scale with the AdamW update, each one
launch over many leaves.

- K-norm (:func:`sum_squares`): Σ x² over many f32 gradients, one f32 partial
  per chunk of ``CHUNK`` elements, then one CTA adds the partials in double;
- K-adamw (:func:`adamw_`): per element, g' = g · factor (the clip's, read
  from the norm on the device), the bias-corrected AdamW step of
  ``Trainer._adamw`` with its plain code's roundings on the card, and p, mu
  and nu written in place.

Together they read each gradient twice and each parameter and moment once,
and write each of those once: 28 bytes a parameter with a bf16 first
moment, where the eager passes moved ~126. Neither syncs with the host.

A launch takes its leaves as a table passed by value in kernel parameter
space; :func:`plan` cuts a list of leaves into launches of at most the
library's capacity and each leaf into chunks (CPU-testable, as is
:func:`fits`, which says which leaves K-adamw takes). On a CUDA device these
kernels are the trainer's only optimizer path: a tensor they cannot take is
refused with a ``ValueError``, and a library that does not build or load
raises. :func:`load` builds and loads it (``Trainer.init_state`` calls it,
so no timed step builds it); ``launches`` counts the launches of each
kernel, and ``reset_launches`` zeroes them.
"""

from __future__ import annotations

import ctypes
from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch

CHUNK = 32768  # elements a CTA takes at a time: csrc/optim.cu's kChunk
# leaves a launch takes with CUDA 12.1+'s 32,764 bytes of kernel parameters
# (csrc/optim.cu's kNormLeaves, kAdamwLeaves); the loaded library's own
# figures replace them
NORM_CAPACITY = 1631
ADAMW_CAPACITY = 741
_INT32_MAX = 2 ** 31 - 1

_lib = None
_capacity = {"norm": NORM_CAPACITY, "adamw": ADAMW_CAPACITY}
launches = {"sumsq": 0, "sumsq_finish": 0, "adamw": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def load():
    """The library, built at its first use in a build directory and loaded
    once. A build or load failure raises."""
    global _lib
    if _lib is None:
        from mpi_operator_tpu_torch.kernels import _build

        lib = _build.library("optim")
        i64, i32 = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
        f32, vp = ctypes.POINTER(ctypes.c_float), ctypes.c_void_p
        for fn, argtypes in {
            "tpujob_optim_chunk": [],
            "tpujob_optim_capacity": [ctypes.c_int],
            "tpujob_sumsq_launch": [i64, i32, ctypes.c_int, vp, vp],
            "tpujob_sumsq_finish": [vp, ctypes.c_int, vp, vp],
            "tpujob_adamw_launch": [i64, i32, ctypes.c_int, ctypes.c_int, vp, f32, vp],
        }.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.tpujob_optim_error_string.argtypes = [ctypes.c_int]
        lib.tpujob_optim_error_string.restype = ctypes.c_char_p
        if lib.tpujob_optim_chunk() != CHUNK:
            raise RuntimeError(f"csrc/optim.cu chunks {lib.tpujob_optim_chunk()} elements, "
                               f"kernels/optim.py plans {CHUNK}")
        _capacity.update(norm=lib.tpujob_optim_capacity(0), adamw=lib.tpujob_optim_capacity(1))
        _lib = lib
    return _lib


def fits(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor) -> bool:
    """Whether K-adamw takes a leaf (its local tensors): f32 parameter,
    gradient and second moment, an f32 or bf16 first moment, all
    contiguous, of one shape, on one device. Element i of each is then the
    same element of the leaf, at the same offset."""
    return (p.dtype == g.dtype == nu.dtype == torch.float32
            and mu.dtype in (torch.float32, torch.bfloat16)
            and p.shape == g.shape == mu.shape == nu.shape
            and p.device == g.device == mu.device == nu.device
            and all(t.is_contiguous() for t in (p, g, mu, nu)))


def plan(sizes: Sequence[int], capacity: int, chunk: int = CHUNK
         ) -> List[Tuple[List[int], List[int]]]:
    """Launches for leaves of ``sizes`` elements, in order: per launch the
    indices of its leaves (at most ``capacity``; empty leaves take none) and
    each one's cumulative count of ``chunk``-element chunks in that launch
    (the kernels' ``chunk_end``, at most 2**31 - 1)."""
    out: List[Tuple[List[int], List[int]]] = []
    idx: List[int] = []
    ends: List[int] = []
    for i, n in enumerate(sizes):
        if n == 0:
            continue
        chunks = -(-n // chunk)
        if idx and (len(idx) == capacity or ends[-1] + chunks > _INT32_MAX):
            out.append((idx, ends))
            idx, ends = [], []
        idx.append(i)
        ends.append((ends[-1] if ends else 0) + chunks)
    if idx:
        out.append((idx, ends))
    return out


def _check(rc: int, what: str) -> None:
    if rc:
        msg = _lib.tpujob_optim_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def _table(rows: Sequence[Sequence[int]], ends: Sequence[int]):
    words = np.asarray(rows, dtype=np.int64)
    chunk_end = np.asarray(ends, dtype=np.int32)
    return (words, chunk_end,
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            chunk_end.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))


def _on_card(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the optimizer kernels take CUDA tensors, not {t.device}")


def sum_squares(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """K-norm: Σ x² over every element of ``tensors`` (contiguous f32 tensors on
    one CUDA device), a 0-d f32 tensor there, with no host sync. Refuses
    any other tensor with a ``ValueError``."""
    for i, t in enumerate(tensors):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != tensors[0].device:
            raise ValueError(f"K-norm takes contiguous f32 tensors on one device; tensor {i} is "
                             f"{t.dtype} of strides {t.stride()} on {t.device}")
        _on_card(t, f"K-norm's tensor {i}")
    lib = load()
    device = tensors[0].device
    plans = plan([t.numel() for t in tensors], _capacity["norm"])
    if not plans:
        return torch.zeros((), dtype=torch.float32, device=device)
    total = sum(ends[-1] for _, ends in plans)
    partials = torch.empty(total, dtype=torch.float32, device=device)
    out = torch.empty((), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        base = partials.data_ptr()
        for idx, ends in plans:
            rows = [(tensors[i].data_ptr(), tensors[i].numel()) for i in idx]
            keep = _table(rows, ends)
            _check(lib.tpujob_sumsq_launch(keep[2], keep[3], len(idx), base, stream),
                   "sumsq_kernel")
            launches["sumsq"] += 1
            base += 4 * ends[-1]
        _check(lib.tpujob_sumsq_finish(partials.data_ptr(), total, out.data_ptr(), stream),
               "sumsq_finish_kernel")
        launches["sumsq_finish"] += 1
    return out


def adamw_(leaves: Mapping[str, Tuple[torch.Tensor, ...]], norm, max_norm: float, lr: float,
           beta1: float, beta2: float, bc1: float, bc2: float, eps: float,
           weight_decay: float) -> None:
    """K-adamw, in place, over ``leaves``: name -> the leaf's (p, g, mu, nu)
    local tensors, all on one CUDA device. The clip's factor from ``norm``
    (a 0-d f32 tensor on the device, the norm before clipping; None: no
    clip) is applied to g as it is read, then ``Trainer._adamw``'s update.
    ``g`` is left as it was. Leaves with a bf16 and an f32 first moment go
    to the two instances of the kernel. A leaf that does not :func:`fits`
    is refused with a ``ValueError`` before anything is written."""
    for name, leaf in leaves.items():
        if not fits(*leaf):
            raise ValueError(
                f"K-adamw cannot take leaf {name}: p, g, mu, nu are "
                f"{[str(t.dtype) for t in leaf]} of shapes {[tuple(t.shape) for t in leaf]}, "
                f"strides {[t.stride() for t in leaf]}; it takes f32 p, g and nu, an f32 or "
                f"bf16 mu, all contiguous, of one shape, on one device")
        _on_card(leaf[0], f"leaf {name}")
    if not leaves:
        return
    lib = load()
    device = next(iter(leaves.values()))[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        norm_ptr = None if norm is None else norm.data_ptr()
        for mu_dtype in (torch.bfloat16, torch.float32):
            group = [leaf for leaf in leaves.values() if leaf[2].dtype == mu_dtype]
            if not group:
                continue
            # b1 rounded to mu's dtype, as the plain path's b1 · mu is
            b1 = torch.tensor(beta1, dtype=mu_dtype).item()
            # 1 / bc in f32: PyTorch divides a CUDA tensor by a Python number
            # as a product with that reciprocal
            inv_bc1, inv_bc2 = (np.float32(1.0) / np.float32(bc) for bc in (bc1, bc2))
            hyper = np.asarray([-lr, b1, 1.0 - beta1, beta2, 1.0 - beta2, inv_bc1, inv_bc2,
                                eps, weight_decay, max_norm], dtype=np.float32)
            hyper_ptr = hyper.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            for idx, ends in plan([leaf[0].numel() for leaf in group], _capacity["adamw"]):
                rows = [tuple(t.data_ptr() for t in group[i]) + (group[i][0].numel(),)
                        for i in idx]
                keep = _table(rows, ends)
                _check(lib.tpujob_adamw_launch(keep[2], keep[3], len(idx),
                                               int(mu_dtype == torch.bfloat16), norm_ptr,
                                               hyper_ptr, stream), "adamw_kernel")
                launches["adamw"] += 1
    # written behind autograd's back: count the writes as an in-place op would
    for p, _, mu, nu in leaves.values():
        for t in (p, mu, nu):
            torch.autograd.graph.increment_version(t)
