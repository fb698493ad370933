"""Mixture-of-Experts FFN with expert parallelism over the ``expert`` axis.

Port of ``mpi_operator_tpu/parallel/moe.py``, the same function:

- a top-1 (switch) router, softmax probabilities with no jitter, the slot
  of a token its 1-based running count within its expert, capacity
  ``max(int(capacity_factor * tokens / n_experts), 1)``;
- tokens scattered into ``[E, C, D]`` capacity buffers (a dropped token
  adds zeros, and its output is zero: it rides the residual), each expert's
  FFN (``gelu`` with the tanh approximation, ``jax.nn.gelu``'s default)
  in ``compute_dtype``, and the gather back scaled by the gate;
- the switch-transformer load-balancing loss.

Parameters are a dict tree shaped as the JAX package's (``init``,
:func:`params_from_jax`): ``router.w`` [D, E], ``w_in.w`` [E, D, F],
``w_out.w`` [E, F, D], all f32.

With a mesh whose ``expert`` axis is above 1, every rank of that axis
holds the same x and computes the same routing; it runs only its own
experts' buffers (E / N of them, in rank order) and the buffers are
gathered over the axis, as JAX's ``shard_map`` over ``P("expert")`` does.
The result equals the local path's, and so do the gradients: every rank
differentiates the same whole output, the gather's backward keeps its own
experts' part, and :func:`~.collectives.scatter_to_group`'s backward
gathers the buffers' and the expert weights' gradients back, so x, the
router and every expert weight get their whole gradient on every rank.

No kernel of its own: the products are ``torch.bmm``, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from mpi_operator_tpu_torch.parallel import collectives as c
from mpi_operator_tpu_torch.runtime.topology import AXIS_EXPERT, axis_group

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 64
    d_ff: int = 256
    n_experts: int = 8
    capacity_factor: float = 1.25
    compute_dtype: torch.dtype = torch.bfloat16


def init(config: MoEConfig, generator: torch.Generator,
         device: Union[str, torch.device, None] = None) -> Params:
    """Random f32 parameters: normal, scaled by d_model^-0.5 (router, w_in)
    and d_ff^-0.5 (w_out). A torch generator does not give JAX's numbers;
    :func:`params_from_jax` loads the JAX package's."""
    d, f, e = config.d_model, config.d_ff, config.n_experts

    def normal(*shape, scale):
        return torch.randn(*shape, generator=generator, device=device) * scale

    return {
        "router": {"w": normal(d, e, scale=d ** -0.5)},
        "w_in": {"w": normal(e, d, f, scale=d ** -0.5)},
        "w_out": {"w": normal(e, f, d, scale=f ** -0.5)},
    }


def params_from_jax(tree: Dict[str, Any],
                    device: Union[str, torch.device, None] = None) -> Params:
    """The JAX ``init`` tree (leaves as arrays) → this module's tree."""
    return {group: {leaf: torch.from_numpy(np.array(v)).to(device) for leaf, v in sub.items()}
            for group, sub in tree.items()}


def logical_axes(config: MoEConfig) -> Dict[str, Dict[str, tuple]]:
    return {
        "router": {"w": ("embed", None)},
        "w_in": {"w": ("expert", "embed", "mlp")},
        "w_out": {"w": ("expert", "mlp", "embed")},
    }


def _route(logits: torch.Tensor, n_experts: int, capacity: int):
    """Top-1 routing with capacity. Returns (expert_idx, slot, keep, gate,
    probs) per token; the slot is a cumulative count per expert."""
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    expert_idx = torch.argmax(probs, dim=-1)  # [T], the first max on ties, as jnp.argmax
    gate = torch.gather(probs, 1, expert_idx[:, None])[:, 0]
    onehot = F.one_hot(expert_idx, n_experts)  # [T, E]
    position = torch.cumsum(onehot, dim=0) * onehot  # 1-based slot per token
    slot = position.max(dim=-1).values - 1  # [T]
    keep = slot < capacity
    return expert_idx, slot, keep, gate, probs


def aux_load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-transformer load-balancing loss: E · Σ_e f_e · P_e."""
    me = F.one_hot(expert_idx, n_experts).to(probs.dtype).mean(dim=0)
    pe = probs.mean(dim=0)
    return n_experts * torch.sum(me * pe)


def _expert_ffn(buf: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                dt: torch.dtype) -> torch.Tensor:
    """Each expert's FFN on its buffer: [E, C, D] → [E, C, D]."""
    h = F.gelu(torch.bmm(buf.to(dt), w_in.to(dt)), approximate="tanh")
    return torch.bmm(h, w_out.to(dt)).to(buf.dtype)


def apply(config: MoEConfig, params: Params, x: torch.Tensor, *, mesh=None):
    """x [B, T, D] → (y [B, T, D], aux_loss scalar).

    With a mesh carrying an ``expert`` axis above 1 each rank runs its
    experts and the buffers are gathered over the axis; otherwise all
    experts run here. The same function either way."""
    b, t, d = x.shape
    e = config.n_experts
    tokens = x.reshape(b * t, d)
    capacity = max(int(config.capacity_factor * b * t / e), 1)

    logits = tokens.float() @ params["router"]["w"]
    expert_idx, slot, keep, gate, probs = _route(logits, e, capacity)
    aux = aux_load_balance_loss(probs, expert_idx, e)

    # scatter tokens into [E, C, D] capacity buffers (dropped → zeros)
    safe_slot = torch.where(keep, slot, torch.zeros_like(slot))
    buf = torch.zeros(e, capacity, d, dtype=tokens.dtype, device=tokens.device)
    buf = buf.index_put((expert_idx, safe_slot),
                        torch.where(keep[:, None], tokens, torch.zeros_like(tokens)),
                        accumulate=True)

    w_in, w_out = params["w_in"]["w"], params["w_out"]["w"]
    group: Optional[object] = axis_group(mesh, AXIS_EXPERT)
    if group is not None:
        if e % c.axis_size(group):
            raise ValueError(f"n_experts={e} does not split over expert={c.axis_size(group)}")
        local = _expert_ffn(c.scatter_to_group(buf, group),
                            c.scatter_to_group(w_in, group),
                            c.scatter_to_group(w_out, group), config.compute_dtype)
        out_buf = c.gather_from_group(local, group)
    else:
        out_buf = _expert_ffn(buf, w_in, w_out, config.compute_dtype)

    # gather back: token i reads its (expert, slot) result, scaled by gate
    gathered = out_buf[expert_idx, safe_slot]
    y = torch.where(keep[:, None], gathered * gate[:, None].to(gathered.dtype),
                    torch.zeros_like(gathered))
    return y.reshape(b, t, d), aux
