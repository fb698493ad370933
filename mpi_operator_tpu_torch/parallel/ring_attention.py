"""Attention over a sequence: this slice ports only the dense oracle.

Port of ``dense_attention`` in ``mpi_operator_tpu/parallel/ring_attention.py``:
the ``attention_impl="dense"`` path of the Llama model and the reference the
tests compare the flash kernels against. The ring itself comes with the
sequence-sharded mesh in a later slice.
"""

from __future__ import annotations

import torch

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
