"""Flash attention (forward + backward) for PyTorch: hand-written CUDA
kernels for Hopper, each beside its plain PyTorch version.

Port of ``mpi_operator_tpu/kernels/flash_attention.py``. The three Pallas
TPU kernels become CUDA kernels in ``csrc/flash_attention.cu``:

- K1 ``flash_fwd``: online-softmax attention → (o, lse), replacing
  ``_fwd_kernel``;
- the backward ``flash_bwd``, replacing ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``: K3 (``flash_bwd_dkv_kernel``) recomputes P and dS
  once per tile pair, sums dk/dv over each kv head's q-head group in
  registers and adds each pair's dq share into an f32 accumulator by TMA
  reduce-adds; the dq pass (``flash_bwd_dq_kernel``) scales and rounds
  that sum. The order of the reduce-adds is not fixed, so dq's f32 sum
  can round differently from run to run; dk and dv are fixed.

The forward and the backward are ``torch.library`` operators
(``flash_fwd_op``, ``flash_bwd_op``), dispatched by the device of the
tensors: a CUDA tensor always goes to the kernels (bf16 only; anything
the kernels do not take raises), a CPU tensor to the plain version. There
is no fallback from one to the other.

Layout: [B, H, T, D] heads-major, k/v at Hkv heads (GQA: q head h reads kv
head h // (H // Hkv)). lse and delta are [B, H, T] f32 (the TPU kernels'
trailing singleton and block padding are gone). v (and so o and dO) may
have a head width Dv of its own: q·kᵀ runs over D, p·v over Dv. The kernels
are compiled at D = Dv in ``HEAD_DIMS`` and at the pairs of
``UNEQUAL_HEAD_DIMS``, (192, 128): multi-head latent attention's q and k of
128 + 64 RoPE columns and its v of 128 (models/deepseek_v3.py).

``window`` (0: none) is a sliding window on top of the causal mask, which
the TPU kernels do not have: key j is visible to query i iff
``i - window < j <= i``. The kernels skip the tiles outside it (K1 starts
its k walk at the first tile that meets ``q0 - window + 1``, K3 ends its q
walk at the last tile that meets ``k_end + window - 1``) and mask its lower
edge inside the edge tiles; on the card it is compiled at D 64 and 128.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from mpi_operator_tpu_torch.kernels import _build
from mpi_operator_tpu_torch.runtime.topology import mesh_sizes

_NEG_INF = -1e30

# The tiles the CUDA kernels are compiled at (csrc/flash_attention.cu); the
# TPU defaults of 1024 were sized for VMEM and do not carry over.
# K1: a CTA takes 128 q rows (two warpgroups of 64) and walks k tiles of 128.
# The plain K1 walks the same tiles by default: the per-row online softmax
# depends only on the k tiling, so it is then the kernel's exact arithmetic.
# (K3's 128 k rows x 64 q rows have no knob: the backward's plain version is
# untiled, and its sums differ from the kernels' in f32 order only.)
BLOCK_Q = 128
BLOCK_K = 128
# Head dims the kernels are compiled at (q, k and v of one width). D 16 and
# 32 run in the D-64 tiles: the TMA box zero-fills the columns past D, and
# only D columns are stored.
HEAD_DIMS = (16, 32, 64, 128)
WINDOW_HEAD_DIMS = (64, 128)  # the windowed instances (WIN 1)
# (q/k width, v width) pairs of unequal widths the kernels are compiled at,
# causal or not, with no window: K1 <192, 0, 128> and K3's own kernel for it
UNEQUAL_HEAD_DIMS = ((192, 128),)

# Launches per kernel, counted by each wrapper right after its kernel was
# accepted by the device (``flash_bwd_dq``: the dq pass; ``flash_bwd_dkv``:
# K3). An unequal pair's instances count under the kernel's name and
# ``.<D>x<Dv>`` (``flash_fwd.192x128``), a key that appears at its first
# launch. ``reset_launches`` zeroes the counts and drops those keys.
_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
launches = dict.fromkeys(_KERNELS, 0)


def _count_launch(name: str, d: int, dv: int) -> None:
    key = name if d == dv else f"{name}.{d}x{dv}"
    launches[key] = launches.get(key, 0) + 1


def reset_launches() -> None:
    launches.clear()
    launches.update(dict.fromkeys(_KERNELS, 0))


# Causal tile-skip algebra (the CUDA kernels' loop bounds use the same
# formulas): a tile pair is computed iff ki * bk < (qi + 1) * bq.


def _causal_open(qi, ki, bq: int, bk: int):
    """True iff k tile ki intersects the causal region of q tile qi."""
    return ki * bk < (qi + 1) * bq


def _causal_last_k_tile(qi, bq: int, bk: int):
    """Largest ki with _causal_open(qi, ki): ceil((qi+1)*bq / bk) - 1."""
    return ((qi + 1) * bq + bk - 1) // bk - 1


def _causal_first_q_tile(ki, bq: int, bk: int):
    """Smallest qi with _causal_open(qi, ki): (ki*bk) // bq."""
    return (ki * bk) // bq


# The window's tile bounds (the CUDA kernels' window_first_k_tile and
# window_last_q_tile).


def _window_first_k_tile(q0: int, window: int, bk: int) -> int:
    """The first k tile holding a key that a query of the q tile starting at
    q0 sees through ``window`` keys."""
    return max(0, q0 - window + 1) // bk


def _window_last_q_tile(k_last: int, window: int, bq: int) -> int:
    """The last q tile holding a query that sees a key of the k tile whose
    last row is ``k_last`` through ``window`` keys."""
    return (k_last + window - 1) // bq


def _check_window(causal: bool, window: int) -> None:
    if window < 0 or (window and not causal):
        raise ValueError(f"window={window}: a window is 0 (none) or positive, on top of "
                         "the causal mask")


def _visible(q_idx, k_idx, window: int):
    """[Tq, Tk] mask of the causal (query, key) pairs, within ``window`` keys
    when it is above 0."""
    d = q_idx[:, None] - k_idx[None, :]
    return (d >= 0) & (d < window) if window else d >= 0


# ---------------------------------------------------------------------------
# plain versions: the same functions in f32, with the kernels' rounding points
# ---------------------------------------------------------------------------


def flash_fwd_plain(
    q, k, v, causal: bool, scale: float, block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain version. q [B,H,T,D], k [B,Hkv,T,D], v [B,Hkv,T,Dv] → (o
    [B,H,T,Dv] in q's dtype, lse [B,H,T] f32). Walks the kernel's tiles: per q tile, an
    online softmax over the k tiles from the window's first to the causal
    bound, P rounded to v's dtype before P·V, fully masked rows emitting 0."""
    _check_window(causal, window)
    b, h, t, d = q.shape
    h_kv, dv = k.shape[1], v.shape[-1]
    g = h // h_kv
    q5 = q.reshape(b, h_kv, g, t, d).float()
    kf = k.float()
    o = torch.empty(b, h_kv, g, t, dv, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h_kv, g, t, dtype=torch.float32, device=q.device)
    n_kb = -(-t // block_k)
    for q0 in range(0, t, block_q):
        qi = q0 // block_q
        qb = q5[:, :, :, q0:q0 + block_q]
        rows = qb.shape[3]
        q_idx = torch.arange(q0, q0 + rows, device=q.device)
        m = torch.full((b, h_kv, g, rows), _NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h_kv, g, rows, dv, device=q.device)
        k_end = min(n_kb, _causal_last_k_tile(qi, block_q, block_k) + 1) if causal else n_kb
        k_first = _window_first_k_tile(q0, window, block_k) if window else 0
        for ki in range(k_first, k_end):
            k0 = ki * block_k
            kb, vb = kf[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
            if causal:
                k_idx = torch.arange(k0, k0 + kb.shape[2], device=q.device)
                s = torch.where(_visible(q_idx, k_idx, window), s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            m = m_new
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vb.dtype).float(), vb.float()
            )
        safe = torch.where(l == 0.0, torch.ones_like(l), l)
        o[:, :, :, q0:q0 + rows] = (acc / safe[..., None]).to(q.dtype)
        lse[:, :, :, q0:q0 + rows] = m + torch.log(safe)
    return o.reshape(b, h, t, dv), lse.reshape(b, h, t)


def _bwd_probs(q, k, v, do, lse, delta, causal: bool, scale: float, window: int = 0):
    """P (f32) and dS = P ⊙ (dO·Vᵀ − delta) (f32, not yet rounded), both
    [B,Hkv,g,Tq,Tk] — what K3 recomputes blockwise."""
    b, h, t, d = q.shape
    h_kv = k.shape[1]
    g = h // h_kv
    q5 = q.reshape(b, h_kv, g, t, d).float()
    do5 = do.reshape(b, h_kv, g, t, do.shape[-1]).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", q5, k.float()) * scale
    p = torch.exp(s - lse.reshape(b, h_kv, g, t)[..., None])
    if causal:
        idx = torch.arange(t, device=q.device)
        p = torch.where(_visible(idx, idx, window), p, 0.0)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do5, v.float())
    ds = p * (dp - delta.reshape(b, h_kv, g, t)[..., None])
    return p, ds


def flash_bwd_plain(q, k, v, do, lse, delta, causal: bool, scale: float, window: int = 0):
    """The backward's plain version → (dq, dk, dv): dq = scale · Σ_k
    bf16(dS)·K, dv = Σ bf16(P)ᵀ·dO and dk = scale · Σ bf16(dS)ᵀ·Q, the last
    two summed over q positions and the kv head's q-head group, all in f32."""
    _check_window(causal, window)
    b, h, t, d = q.shape
    h_kv = k.shape[1]
    g = h // h_kv
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale, window)
    q5 = q.reshape(b, h_kv, g, t, d).float()
    do5 = do.reshape(b, h_kv, g, t, do.shape[-1]).float()
    ds_k = ds.to(k.dtype).float()  # dS rounded as each product's operand
    ds_q = ds_k if q.dtype == k.dtype else ds.to(q.dtype).float()
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds_k, k.float()) * scale
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(do.dtype).float(), do5)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds_q, q5) * scale
    return dq.reshape(b, h, t, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_fwd_bf16": [_P] * 5 + [_I] * 8 + [_F, _P],
    "flash_bwd_dkv_bf16": [_P] * 9 + [_I] * 8 + [_F, _P],
    "flash_bwd_dq_bf16": [_P, _P, ctypes.c_longlong, _F, _P],
}


def _lib():
    return _build.typed_library("flash_attention", _SIGNATURES, "flash_error_string")


def _operand(x: torch.Tensor, name: str, shape) -> torch.Tensor:
    """Validate one kernel operand and hand back a contiguous, 16-byte
    aligned tensor (the kernels load 16 bytes per thread)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def _dims(q, k, v, causal: bool = True, window: int = 0):
    _check_window(causal, window)
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"the CUDA flash kernels take bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q/k/v must be [B,H,T,D] / [B,Hkv,T,D] / [B,Hkv,T,Dv]")
    b, h, t, d = q.shape
    h_kv, dv = k.shape[1], v.shape[-1]
    if tuple(v.shape[:3]) != tuple(k.shape[:3]):
        raise ValueError(f"v {tuple(v.shape)} and k {tuple(k.shape)} differ before the head width")
    if dv != d:
        if (d, dv) not in UNEQUAL_HEAD_DIMS:
            raise ValueError(f"(q/k, v) head widths ({d}, {dv}) not supported by the CUDA "
                             f"kernels: equal widths in {HEAD_DIMS} or the pairs "
                             f"{UNEQUAL_HEAD_DIMS}")
        if window:
            raise ValueError(f"the ({d}, {dv}) CUDA kernels have no window, got {window}")
    elif d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the CUDA kernels ({HEAD_DIMS}, or "
                         f"the (q/k, v) pairs {UNEQUAL_HEAD_DIMS})")
    if window and d not in WINDOW_HEAD_DIMS:
        raise ValueError(f"the windowed CUDA kernels are compiled at head_dim "
                         f"{WINDOW_HEAD_DIMS}, got {d}")
    if h_kv == 0 or h % h_kv:
        raise ValueError(f"H={h} is not a multiple of Hkv={h_kv}")
    if t == 0 or b * h > 65535:  # the grid's second dimension is b*h (b*h_kv for K3)
        raise ValueError(f"the CUDA kernels take 0 < T and B*H <= 65535, got T={t}, B*H={b * h}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    return b, h, h_kv, t, d, dv


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_fwd_cuda(q, k, v, causal: bool, scale: float, window: int = 0):
    """Launch K1. Returns (o [B,H,T,Dv] bf16, lse [B,H,T] f32)."""
    b, h, h_kv, t, d, dv = _dims(q, k, v, causal, window)
    q = _operand(q, "q", (b, h, t, d))
    k = _operand(k, "k", (b, h_kv, t, d))
    v = _operand(v, "v", (b, h_kv, t, dv))
    o = q.new_empty(b, h, t, dv)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, h_kv, t, d, dv, int(causal), int(window), float(scale), _stream(q.device),
        )
    _build.check(lib, rc, "flash_fwd")
    _count_launch("flash_fwd", d, dv)
    return o, lse


def _bwd_operands(q, k, v, do, lse, delta, causal: bool, window: int):
    b, h, h_kv, t, d, dv = _dims(q, k, v, causal, window)
    if do.dtype != q.dtype:
        raise ValueError(f"dO must be {q.dtype}, got {do.dtype}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError("lse and delta must be float32")
    return (b, h, h_kv, t, d, dv), (
        _operand(q, "q", (b, h, t, d)),
        _operand(k, "k", (b, h_kv, t, d)),
        _operand(v, "v", (b, h_kv, t, dv)),
        _operand(do, "dO", (b, h, t, dv)),
        _operand(lse, "lse", (b, h, t)),
        _operand(delta, "delta", (b, h, t)),
    )


def flash_bwd_cuda(q, k, v, do, lse, delta, causal: bool, scale: float, window: int = 0):
    """Launch K3, then the dq pass. Returns (dq [B,H,T,D], dk [B,Hkv,T,D],
    dv [B,Hkv,T,Dv]), bf16. K3 adds dq's f32 sum into a zeroed [B,H,T,D]
    accumulator, which lives until the pass has read it."""
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, dq_acc, causal, scale, window)
    return flash_bwd_dq_cuda(dq_acc, scale, v.shape[-1]), dk, dv


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, dq_acc, causal: bool, scale: float,
                       window: int = 0):
    """Launch K3 alone: returns (dk [B,Hkv,T,D], dv [B,Hkv,T,Dv]) bf16 and
    adds dq's unscaled f32 sum into ``dq_acc`` (f32 [B,H,T,D] on the card)."""
    (b, h, h_kv, t, d, dv_), ops = _bwd_operands(q, k, v, do, lse, delta, causal, window)
    if (dq_acc.dtype != torch.float32 or tuple(dq_acc.shape) != (b, h, t, d)
            or dq_acc.device != ops[0].device or not dq_acc.is_contiguous()
            or dq_acc.data_ptr() % 16):
        raise ValueError(f"dq_acc must be a contiguous, 16-byte aligned f32 {(b, h, t, d)} "
                         f"on {ops[0].device}, got {dq_acc.dtype} {tuple(dq_acc.shape)}")
    dk = torch.empty_like(ops[1])
    dv = torch.empty_like(ops[2])
    lib = _lib()
    with torch.cuda.device(dk.device):
        rc = lib.flash_bwd_dkv_bf16(
            *(x.data_ptr() for x in ops), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, h_kv, t, d, dv_, int(causal), int(window), float(scale), _stream(dk.device),
        )
    _build.check(lib, rc, "flash_bwd_dkv")
    _count_launch("flash_bwd_dkv", d, dv_)
    return dk, dv


def flash_bwd_dq_cuda(dq_acc, scale: float, dv: Optional[int] = None):
    """Launch the dq pass: bf16(scale · dq_acc) for an f32 CUDA tensor whose
    last dimension D is a head dim of ``HEAD_DIMS`` or a q/k width of
    ``UNEQUAL_HEAD_DIMS``; ``dv`` (v's width, D by default) names the launch
    count (the pass itself is one kernel for every width)."""
    dims = HEAD_DIMS + tuple(d for d, _ in UNEQUAL_HEAD_DIMS)
    if dq_acc.dtype != torch.float32 or dq_acc.shape[-1] not in dims:
        raise ValueError(f"the dq pass takes f32 [..., D] with D in {dims}, got "
                         f"{dq_acc.dtype} {tuple(dq_acc.shape)}")
    dq_acc = _operand(dq_acc, "dq_acc", dq_acc.shape)
    dq = torch.empty(dq_acc.shape, dtype=torch.bfloat16, device=dq_acc.device)
    lib = _lib()
    with torch.cuda.device(dq.device):
        rc = lib.flash_bwd_dq_bf16(
            dq_acc.data_ptr(), dq.data_ptr(), dq_acc.numel(), float(scale), _stream(dq.device),
        )
    _build.check(lib, rc, "flash_bwd_dq")
    _count_launch("flash_bwd_dq", dq.shape[-1], dv or dq.shape[-1])
    return dq


# ---------------------------------------------------------------------------
# the forward and the backward as operators, dispatched by device
# ---------------------------------------------------------------------------
#
# Each is a ``torch.library`` operator: the CUDA kernels for CUDA tensors,
# the plain version for CPU tensors, a fake for shapes. An operator
# is what the dispatcher sees (meta shapes, dispatch modes such as selective
# checkpointing); a ctypes launch inside an autograd Function is not. The
# launch counts stay in the CUDA wrappers above. A dispatch through
# ``torch.library`` costs some microseconds a call on the host.

OPS_NAMESPACE = "mpi_operator_tpu_torch"


@torch.library.custom_op(
    f"{OPS_NAMESPACE}::flash_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float scale, int block_q, "
           "int block_k, int window=0) -> (Tensor, Tensor)",
)
def flash_fwd_op(q, k, v, causal, scale, block_q, block_k, window=0):
    """K1 → (o, lse); on CPU tensors its plain version."""
    return flash_fwd_plain(q, k, v, causal, scale, block_q=block_q, block_k=block_k,
                           window=window)


@flash_fwd_op.register_kernel("cuda")
def _flash_fwd_kernel(q, k, v, causal, scale, block_q, block_k, window=0):
    if (block_q, block_k) != (BLOCK_Q, BLOCK_K):
        raise ValueError(
            f"the CUDA kernel's tiles are {BLOCK_Q}x{BLOCK_K}; got {block_q}x{block_k}"
        )
    return flash_fwd_cuda(q, k, v, causal, scale, window)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, block_q, block_k, window=0):
    return q.new_empty(*q.shape[:3], v.shape[-1]), q.new_empty(q.shape[:3], dtype=torch.float32)


_BWD_ARGS = ("(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, Tensor delta, "
             "bool causal, float scale, int window=0)")


@torch.library.custom_op(
    f"{OPS_NAMESPACE}::flash_bwd", mutates_args=(), device_types="cpu",
    schema=f"{_BWD_ARGS} -> (Tensor, Tensor, Tensor)",
)
def flash_bwd_op(q, k, v, do, lse, delta, causal, scale, window=0):
    """The backward → (dq, dk, dv): K3 and the dq pass; on CPU tensors the
    plain version."""
    return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale, window)


flash_bwd_op.register_kernel("cuda")(flash_bwd_cuda)


@flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, do, lse, delta, causal, scale, window=0):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, scale, _, _, window = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.scale, ctx.window = causal, scale, window


def _flash_backward(ctx, do, _dlse):
    """The JAX ``_flash`` custom_vjp's backward: delta = rowsum(dO·O) in f32,
    outside the kernels, then one backward call."""
    q, k, v, o, lse = ctx.saved_tensors
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = flash_bwd_op(q, k, v, do, lse, delta, ctx.causal, ctx.scale, ctx.window)
    return dq, dk, dv, None, None, None, None, None


flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got {x.device}")


def flash_fwd(
    q, k, v, *, causal: bool, scale: float, block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
    window: int = 0,
):
    """K1 on CUDA tensors, its plain version on CPU tensors; differentiable
    (``flash_bwd_op`` in the backward). Returns (o, lse)."""
    _check_device(q)
    return flash_fwd_op(q, k, v, causal, float(scale), block_q, block_k, int(window))


def _check_local_heads(mesh, h: int, h_kv: int) -> None:
    """Activations are rank-local: over ``data``/``fsdp`` the inputs are this
    rank's batch, and over ``tensor`` its heads, which must keep whole GQA
    groups (the JAX package shards heads only when both counts divide). A
    sequence split over ``sequence`` is the ring's (parallel/ring_attention.py)."""
    sizes = mesh_sizes(mesh)
    if sizes.get("sequence", 1) > 1:
        raise ValueError(
            f"flash_attention over a mesh with sequence={sizes['sequence']}: the local "
            "queries would miss the other ranks' keys; use ring_attention"
        )
    if h_kv == 0 or h % h_kv:
        raise ValueError(
            f"this rank's {h} q heads do not group over its {h_kv} kv heads "
            f"(tensor={sizes.get('tensor', 1)}): each rank must hold whole GQA groups"
        )


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
    mesh=None,
    layout: str = "bthd",
    window: int = 0,
):
    """Flash attention in model layout q [B,T,H,D], k [B,T,Hkv,D], v
    [B,T,Hkv,Dv] (Dv = D, or a pair of ``UNEQUAL_HEAD_DIMS`` on the card) or,
    with ``layout="bhtd"``, in the kernels' heads-major layout; o has v's
    width, and ``scale`` defaults to D^-1/2. Differentiable.
    ``window`` (with ``causal``): each query sees its last ``window`` keys,
    itself included; 0 is none.

    CUDA tensors run the kernels; K1's tiles are compiled at ``BLOCK_Q`` ×
    ``BLOCK_K``, and a different ``block_q``/``block_k`` raises there. CPU
    tensors run the plain versions, which walk the same tiles (``block_q`` ×
    ``block_k``). ``mesh`` (a ``DeviceMesh``) is the JAX signature's: the
    inputs are this rank's batch and, over ``tensor``, its heads, and
    attention runs on them; heads that do not form whole GQA groups and a
    ``sequence`` axis above 1 raise ``ValueError``."""
    if layout not in ("bthd", "bhtd"):
        raise ValueError(f"layout={layout!r}; expected bthd|bhtd")
    if mesh is not None:
        h_dim = 1 if layout == "bhtd" else 2
        _check_local_heads(mesh, q.shape[h_dim], k.shape[h_dim])
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if layout == "bthd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    o, _ = flash_fwd(q, k, v, causal=causal, scale=scale, block_q=block_q, block_k=block_k,
                     window=window)
    return o if layout == "bhtd" else o.transpose(1, 2)


# ---------------------------------------------------------------------------
# references (heads-major), and the model-layout chunked reference
# ---------------------------------------------------------------------------


def _block_reference(q_blk, k, v, q_offset: int, *, causal: bool, scale: float):
    """Attention for one q block against full K/V (heads-major, GQA-aware),
    in f32. q_blk [B,H,BQ,D], k/v [B,Hkv,T,D]."""
    b, h, bq, d = q_blk.shape
    h_kv = k.shape[1]
    g = h // h_kv
    q5 = q_blk.reshape(b, h_kv, g, bq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", q5, k.float()) * scale
    s = s.reshape(b, h, bq, k.shape[2])
    if causal:
        q_idx = q_offset + torch.arange(bq, device=q_blk.device)[:, None]
        k_idx = torch.arange(k.shape[2], device=q_blk.device)[None, :]
        s = torch.where((q_idx >= k_idx)[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    p5 = p.reshape(b, h_kv, g, bq, k.shape[2])
    o = torch.einsum("bhgqk,bhkd->bhgqd", p5, v.float())
    return o.reshape(b, h, bq, v.shape[-1]).to(q_blk.dtype)


def _chunked_reference(q, k, v, *, causal: bool, scale: float, block_q: int):
    """Memory-bounded reference: checkpointed q blocks, so the backward
    stores only block inputs and recomputes scores blockwise."""
    t = q.shape[2]
    bq = min(block_q, t)
    outs = [
        checkpoint(
            _block_reference, q[:, :, q0:q0 + bq], k, v, q0,
            causal=causal, scale=scale, use_reentrant=False,
        )
        for q0 in range(0, t, bq)
    ]
    return torch.cat(outs, dim=2)


def _dense_reference(q, k, v, *, causal: bool, scale: float):
    """Unchunked reference (numerics tests)."""
    return _block_reference(q, k, v, 0, causal=causal, scale=scale)


def chunked_reference(q, k, v, *, causal: bool = True, scale=None, block_q: int = 256):
    """The chunked reference in model layout (q [B,T,H,D]), a copy of the
    JAX package's ``chunked_reference`` (plain softmax, no tile walk). Nothing
    on the training path calls it; the kernels are held against the
    ``*_plain`` versions above."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _chunked_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, scale=scale, block_q=block_q,
    ).transpose(1, 2)
