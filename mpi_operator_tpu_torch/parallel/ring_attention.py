"""Ring attention: exact attention over a sequence split across the ranks of
the ``sequence`` axis, folded through the flash kernels; and the dense
oracle.

Port of ``mpi_operator_tpu/parallel/ring_attention.py``. Each rank holds a
contiguous block of T (its queries and its K/V). K/V blocks travel one hop
around the ring per step (shift-then-consume, as the JAX code does: the
resident block first, then one neighbour hop before each of the n - 1
others), and each rank folds every block that is not in its future:

- forward: K1 (``flash_fwd_op``) on each block, ``causal=True`` on the
  rank's own block and ``causal=False`` on older ones; blocks newer than
  the local queries are skipped. The (o_j, lse_j) pairs merge in f32 by
  the log-sum-exp rule and o is cast once at the end;
- backward: delta = rowsum(dO·O) from the merged O, then the backward
  kernels (``flash_bwd_op``) on each visited block with the merged lse, so
  every block sees the global softmax. dq sums at home
  in f32; the dk/dv partials of a block travel with it around the ring,
  summed in f32, and take one last hop home to the block's owner.

The JAX ring folds each block with plain f32 einsums under ``shard_map``
(no Pallas kernel); the port computes the same function with the
hand-written kernels. The per-rank fold (:func:`fold_forward`,
:func:`block_backward`) is kept apart from the transport, so one process
can drive the fold of every rank of a ring on one card
(:func:`fold_every_rank`). The plain version,
:func:`ring_attention_plain`, is the JAX ring's own math (``_scores``,
``_weighted_v``, ``_block``, f32 accumulators) over every rank's block in
one process.

Layout follows ``flash_attention``: q [B,T,H,D], k/v [B,T,Hkv,D] (or
heads-major with ``layout="bhtd"``), this rank's block of T. Heads are
GQA-grouped; K/V travel at Hkv heads.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from mpi_operator_tpu_torch.kernels.flash_attention import (
    BLOCK_K,
    BLOCK_Q,
    flash_attention,
    flash_bwd_op,
    flash_fwd_op,
)
from mpi_operator_tpu_torch.parallel.collectives import (
    axis_index,
    axis_size,
    ring_shift_start,
    ring_shift_wait,
)
from mpi_operator_tpu_torch.runtime.topology import AXIS_SEQ, axis_group

_NEG_INF = -1e30  # large-negative instead of -inf: exp()/max() stay NaN-free


def dense_attention(q, k, v, *, causal: bool, scale: float):
    """q [B,T,H,D], k/v [B,T,Hkv,D] → [B,T,H,D] in q's dtype. GQA-aware:
    consecutive q heads share a kv head; K/V are never expanded. Scores,
    softmax and the P·V product run in f32."""
    b, t_q, h, d = q.shape
    t_k, h_kv = k.shape[1], k.shape[2]
    g = h // h_kv
    q5 = q.reshape(b, t_q, h_kv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k.float()) * scale
    if causal:
        mask = torch.arange(t_q, device=q.device)[:, None] >= torch.arange(
            t_k, device=q.device
        )[None, :]
        s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, t_q, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# the fold: one rank's compute, given the blocks in visit order
# ---------------------------------------------------------------------------


def block_causality(index: int, source: int, causal: bool) -> Optional[bool]:
    """How rank ``index`` folds the block that ``source`` owns: True (the
    triangular mask: its own block), False (no mask: an older block, or
    any block without ``causal``), None (skipped: a newer block)."""
    if not causal:
        return False
    if source == index:
        return True
    return False if source < index else None


def merge(acc: Optional[Tuple[torch.Tensor, torch.Tensor]], o, lse):
    """Fold one block's (o, lse) (o normalised over the block, lse its
    log-sum-exp) into the running (o, lse), in f32."""
    o = o.float()
    if acc is None:
        return o, lse
    o_acc, lse_acc = acc
    lse_new = torch.logaddexp(lse_acc, lse)
    o_new = (o_acc * torch.exp(lse_acc - lse_new)[..., None]
             + o * torch.exp(lse - lse_new)[..., None])
    return o_new, lse_new


def fold_forward(q, blocks: Iterable, *, scale: float):
    """K1 on q [B,H,Tq,D] against each (k, v, causal) of ``blocks`` (k/v
    [B,Hkv,Tk,D]), merged. Returns (o in q's dtype, lse [B,H,Tq] f32)."""
    acc = None
    for k, v, causal in blocks:
        acc = merge(acc, *flash_fwd_op(q, k, v, causal, scale, BLOCK_Q, BLOCK_K))
    if acc is None:
        raise ValueError("a fold needs at least one block")
    o, lse = acc
    return o.to(q.dtype), lse


def block_backward(q, k, v, do, lse, delta, causal: bool, scale: float):
    """The backward of one block against the merged ``lse`` and ``delta``:
    (dq, dk, dv) of this block's share, in the kernels' dtype."""
    return flash_bwd_op(q, k, v, do, lse, delta, causal, scale)


def attention_delta(do, o):
    """delta = rowsum(dO·O) in f32, as the JAX ``_flash`` backward takes it."""
    return (do.float() * o.float()).sum(-1)


def fold_every_rank(q, k, v, do, n: int, *, causal: bool, scale: float):
    """The fold of every rank of an n-rank ring, in one process: q and dO
    [B,H,T,D], k/v [B,Hkv,T,D] are the whole sequence, and rank i's blocks
    are the i-th of n slices of T, visited in the ring's order. Each rank
    runs :func:`fold_forward`, then :func:`block_backward` per visited block
    with its merged lse; dq sums per rank and each block's dk/dv over the
    ranks that visited it, in f32. Returns (o, lse, dq, dk, dv) over the
    whole T. The kernels see the shapes and modes the ring gives them; only
    the transport is missing (one card cannot hold two NCCL ranks)."""
    qs, ks, vs, dos = ([c.contiguous() for c in x.chunk(n, dim=2)] for x in (q, k, v, do))
    dks = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in ks]
    dvs = [torch.zeros_like(x) for x in dks]
    outs, lses, dqs = [], [], []
    for i in range(n):
        visits = [(j, block_causality(i, j, causal)) for j in ((i - s) % n for s in range(n))]
        visits = [(j, how) for j, how in visits if how is not None]
        o, lse = fold_forward(qs[i], ((ks[j], vs[j], how) for j, how in visits), scale=scale)
        delta = attention_delta(dos[i], o)
        dq = torch.zeros(qs[i].shape, dtype=torch.float32, device=q.device)
        for j, how in visits:
            dq_j, dk_j, dv_j = block_backward(qs[i], ks[j], vs[j], dos[i], lse, delta, how, scale)
            dq += dq_j
            dks[j] += dk_j
            dvs[j] += dv_j
        outs.append(o)
        lses.append(lse)
        dqs.append(dq.to(q.dtype))
    return (torch.cat(outs, 2), torch.cat(lses, 2), torch.cat(dqs, 2),
            torch.cat(dks, 2).to(k.dtype), torch.cat(dvs, 2).to(v.dtype))


# ---------------------------------------------------------------------------
# the transport: K/V around the ring, the dk/dv partials home
# ---------------------------------------------------------------------------


def _ring_blocks(k, v, group, index: int, n: int, causal: bool):
    """Yield (k, v, causal) of each block rank ``index`` folds, in visit
    order. Every rank takes part in all n - 1 hops, the blocks it skips
    included; the next hop is in flight while the current block computes."""
    for step in range(n):
        hop = ring_shift_start([k, v], group) if step + 1 < n else None
        how = block_causality(index, (index - step) % n, causal)
        if how is not None:
            yield k, v, how
        if hop is not None:
            (k, v), requests = hop
            ring_shift_wait(requests)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        q, k, v = (x.contiguous() for x in (q, k, v))
        n, index = axis_size(group), axis_index(group)
        o, lse = fold_forward(q, _ring_blocks(k, v, group, index, n, causal), scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, index = axis_size(group), axis_index(group)
        do = do.contiguous()
        delta = attention_delta(do, o)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for step in range(n):
            # at this step the resident block is (index - step)'s, with the
            # partials of the ranks it visited before; after the last step
            # it is (index + 1)'s, and its partials take the hop home
            hop = ring_shift_start([k, v], group) if step + 1 < n else None
            how = block_causality(index, (index - step) % n, causal)
            if how is not None:
                dq_j, dk_j, dv_j = block_backward(q, k, v, do, lse, delta, how, scale)
                dq += dq_j
                dk += dk_j
                dv += dv_j
            (dk, dv), requests = ring_shift_start([dk, dv], group)
            ring_shift_wait(requests)
            if hop is not None:
                (k, v), requests = hop
                ring_shift_wait(requests)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(
    q,
    k,
    v,
    mesh,
    *,
    axis_name: str = AXIS_SEQ,
    causal: bool = True,
    scale: Optional[float] = None,
    layout: str = "bthd",
):
    """Exact attention with T split over ``axis_name``: q, k, v are this
    rank's block (q [B,T/N,H,D], k/v [B,T/N,Hkv,D], or heads-major with
    ``layout="bhtd"``) and so is the result. Differentiable.

    ``mesh`` is the ``DeviceMesh`` (or the process group of its
    ``axis_name`` axis). Without that axis, or at size 1, attention is
    local: ``flash_attention``, as the JAX ring goes to its chunked
    reference. CUDA tensors run the kernels (bf16), CPU tensors their plain
    versions."""
    if layout not in ("bthd", "bhtd"):
        raise ValueError(f"layout={layout!r}; expected bthd|bhtd")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    group = axis_group(mesh, axis_name) if hasattr(mesh, "mesh_dim_names") else mesh
    if group is None or axis_size(group) == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale, layout=layout)
    if layout == "bthd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    o = _RingAttention.apply(q, k, v, group, causal, float(scale))
    return o if layout == "bhtd" else o.transpose(1, 2)


# ---------------------------------------------------------------------------
# the plain version: the JAX ring's math, every rank's block in one process
# ---------------------------------------------------------------------------


def _scores(q, k, scale):
    """q [B,Tq,H,D], k [B,Tk,Hkv,D] → [B,H,Tq,Tk] f32, GQA-grouped."""
    b, t_q, h, d = q.shape
    h_kv = k.shape[2]
    q5 = q.reshape(b, t_q, h_kv, h // h_kv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), k.float())
    return s.reshape(b, h, t_q, k.shape[1]) * scale


def _weighted_v(p, v):
    """p [B,H,Tq,Tk] × v [B,Tk,Hkv,D] → [B,Tq,H,D] (grouped, see _scores)."""
    b, h, t_q, t_k = p.shape
    h_kv = v.shape[2]
    p5 = p.reshape(b, h_kv, h // h_kv, t_q, t_k)
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p5, v.to(p.dtype))
    return pv.reshape(b, t_q, h, v.shape[3])


def _block(q, k, v, bias, carry, scale):
    """Fold one K/V block into the online-softmax carry (o [B,Tq,H,D]
    unnormalised, m and l [B,H,Tq])."""
    o, m, l = carry
    s = _scores(q, k, scale)
    if bias is not None:
        s = s + bias
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    o_new = o * corr.transpose(1, 2)[..., None] + _weighted_v(p, v)
    return o_new, m_new, l_new


def ring_attention_plain(q, k, v, n: int, *, causal: bool = True, scale: Optional[float] = None):
    """The JAX ring's fold for each of ``n`` ranks, in one process: q
    [B,T,H,D], k/v [B,T,Hkv,D] are the whole sequence, split into n blocks;
    rank i folds the blocks (i - s) mod n for s = 0..n-1 with the JAX
    package's bias (future blocks masked to -1e30, not skipped) and f32
    accumulators. Returns [B,T,H,D] in q's dtype; differentiable."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs, ks, vs = (x.chunk(n, dim=1) for x in (q, k, v))
    t_q, t_k = qs[0].shape[1], ks[0].shape[1]
    outs = []
    for i in range(n):
        q32 = qs[i].float()
        b, _, h, _ = q32.shape
        carry = (torch.zeros_like(q32),
                 torch.full((b, h, t_q), _NEG_INF, device=q.device),
                 torch.zeros(b, h, t_q, device=q.device))
        for step in range(n):
            src = (i - step) % n
            bias = None
            if causal:
                q_pos = i * t_q + torch.arange(t_q, device=q.device)[:, None]
                k_pos = src * t_k + torch.arange(t_k, device=q.device)[None, :]
                bias = torch.where(q_pos >= k_pos, 0.0, _NEG_INF)[None, None]
            carry = _block(q32, ks[src], vs[src], bias, carry, scale)
        o, _, l = carry
        outs.append((o / l.transpose(1, 2)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)
