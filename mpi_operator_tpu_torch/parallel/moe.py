"""Mixture-of-Experts FFNs: the switch layer with expert parallelism over the
``expert`` axis, and a dropless token-choice top-k layer.

The switch layer (:func:`apply`) is a port of
``mpi_operator_tpu/parallel/moe.py``, the same function:

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

:class:`TokenChoiceMoE` has no JAX twin (the AFMoE block, models/afmoe.py):
sigmoid scores, top-k selection on the scores plus a balancing bias, the
selected scores normalised and scaled as the weights, and no capacity: no
token is dropped. The T·k (token, expert) pairs are sorted by expert, their
rows gathered into one buffer in expert order (each expert's rows padded
with zero rows to a multiple of ``ROW_ALIGN``), the three expert products
run as grouped products over per-expert row offsets, and each token's k
weighted outputs are gathered back and summed in f32. Every size is fixed
by the shapes, so nothing waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mpi_operator_tpu_torch.kernels.quant_matmul import quant_matmul
from mpi_operator_tpu_torch.parallel import collectives as c
from mpi_operator_tpu_torch.runtime import stepstats
from mpi_operator_tpu_torch.runtime.stepstats import span
from mpi_operator_tpu_torch.runtime.topology import AXIS_EXPERT, axis_group, mesh_sizes

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


# ---------------------------------------------------------------------------
# the dropless token-choice top-k layer
# ---------------------------------------------------------------------------

# Each expert's rows are padded to a multiple of this with zero rows: the
# grouped products' weight gradient contracts over an expert's rows, whose
# groups the card's grouped GEMM takes in 16-byte (8 bf16) steps.
ROW_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class TopKConfig:
    d_model: int = 64
    d_expert: int = 32  # each expert's SwiGLU width
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 1  # shared experts, one SwiGLU of width n_shared · d_expert
    route_scale: float = 1.0  # the weights: the selected scores over their sum, times this
    balance_coeff: float = 1e-3  # the expert bias's step (after_update)
    compute_dtype: torch.dtype = torch.bfloat16
    matmul_precision: str = "bf16"  # the shared expert's products (kernels/quant_matmul)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """y = x_g · w[g] for each group g of the rows of x [M, K] (``ends``:
    each group's end row, int32 [E] on x's device), w [E, K, N] → [M, N];
    differentiable. On a CUDA tensor ``torch._grouped_mm`` (whose backward
    is the transposed grouped products; rows past the last end are not
    computed and hold garbage), on a CPU tensor :func:`grouped_mm_plain`."""
    if x.is_cuda:
        return torch._grouped_mm(x, w, offs=ends)
    return grouped_mm_plain(x, w, ends)


def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_mm`'s plain version: one ``torch.mm`` per expert; rows
    past the last end are zeros. Reads ``ends`` on the host."""
    bounds = [0] + ends.tolist()
    parts = [x[a:b] @ w[e] for e, (a, b) in enumerate(zip(bounds, bounds[1:]))]
    parts.append(x.new_zeros(x.shape[0] - bounds[-1], w.shape[-1]))
    return torch.cat(parts)


def route(scores: torch.Tensor, bias: torch.Tensor, config: TopKConfig):
    """(experts [T, k], weights [T, k] f32) of sigmoid ``scores`` [T, E]
    (f32): the top-k of scores + bias (the bias selects and weighs
    nothing), their scores normalised over the k and scaled."""
    experts = torch.topk(scores.detach() + bias, config.top_k, dim=-1).indices
    w = scores.gather(1, experts)
    return experts, w / w.sum(-1, keepdim=True) * config.route_scale


def dispatch(experts: torch.Tensor, n_experts: int):
    """Where each (token, slot) pair's row goes in the expert-ordered buffer.
    ``experts`` [T, k] → (dest [T, k]: its row; ends int32 [E]: each
    expert's end row, padded; counts [E] int64: rows routed to each
    expert; rows: the buffer's fixed length, T·k + E·(ROW_ALIGN - 1)). A
    stable sort by expert keeps each expert's rows in token order."""
    flat = experts.reshape(-1)
    n = flat.numel()
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    padded = (counts + ROW_ALIGN - 1) // ROW_ALIGN * ROW_ALIGN
    ends = padded.cumsum(0)
    first = counts.cumsum(0) - counts  # each expert's first pair in sorted order
    by_expert = flat[order]
    rank = torch.arange(n, device=flat.device) - first[by_expert]
    dest = torch.empty_like(order)
    dest[order] = ends[by_expert] - padded[by_expert] + rank
    return dest.view_as(experts), ends.to(torch.int32), counts, n + n_experts * (ROW_ALIGN - 1)


def check_mesh(mesh) -> None:
    """The token-choice layer holds every expert: it has no exchange over an
    ``expert`` axis yet."""
    n = mesh_sizes(mesh).get(AXIS_EXPERT, 1) if mesh is not None else 1
    if n > 1:
        raise ValueError(f"the token-choice MoE holds all its experts and has no exchange "
                         f"over expert={n}")


class TokenChoiceMoE(nn.Module):
    """Dropless token-choice top-k MoE FFN with a shared expert: x [B, T, D]
    (compute dtype) → y [B, T, D].

    Parameters (f32, ``[in, out]``): ``router`` [D, E]; ``w_gate``,
    ``w_up`` [E, D, F] and ``w_down`` [E, F, D]; ``shared_gate``,
    ``shared_up`` [D, S·F] and ``shared_down`` [S·F, D]. Buffers:
    ``expert_bias`` [E] (selection only, moved by :meth:`after_update`) and
    ``expert_load`` [E] (rows routed to each expert since the last update,
    this rank's; ``sum_loads`` sums them over the ranks at the update).

    Scores are ``sigmoid(x·router)`` in f32; the experts' SwiGLUs
    (``w_down(silu(x w_gate) * (x w_up))``) run in the compute dtype, as
    grouped products on a CUDA device and one product per expert on the
    CPU. ``name`` prefixes its counters (runtime/stepstats.count, during a
    capture): ``<name>.rows`` [E], ``<name>.max_rows`` (the busiest
    expert's rows), ``<name>.padding`` (zero rows added) and
    ``<name>.assignments`` (T·k).
    """

    def __init__(self, config: TopKConfig, device=None, name: str = "moe"):
        super().__init__()
        c = config
        self.config, self.name = c, name
        e, d, f, fs = c.n_experts, c.d_model, c.d_expert, c.n_shared * c.d_expert

        def p(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.router = p(d, e)
        self.w_gate, self.w_up, self.w_down = p(e, d, f), p(e, d, f), p(e, f, d)
        self.shared_gate, self.shared_up, self.shared_down = p(d, fs), p(d, fs), p(fs, d)
        self.register_buffer("expert_bias", torch.zeros(e, device=device))
        self.register_buffer("expert_load", torch.zeros(e, device=device))
        self.sum_loads = False  # set_parallel: every rank's rows feed the bias step

    def forward(self, x: torch.Tensor, count: bool = True) -> torch.Tensor:
        """``count``: add this call's routing to ``expert_load`` and the
        counters (off for a remat's recompute of the same forward)."""
        c = self.config
        dt = c.compute_dtype
        b, t, d = x.shape
        xs = x.reshape(b * t, d)
        with span("moe.route"):
            scores = torch.sigmoid(xs.float() @ self.router)
            experts, weights = route(scores, self.expert_bias, c)
            k = experts.shape[1]
        with span("moe.dispatch"):
            dest, ends, counts, rows = dispatch(experts, c.n_experts)
            if count:
                self._count(counts, ends)
            buf = xs.new_zeros(rows, d).index_copy(0, dest.reshape(-1),
                                                   xs.repeat_interleave(k, dim=0))
        with span("moe.experts"):
            h = (F.silu(grouped_mm(buf, self.w_gate.to(dt), ends))
                 * grouped_mm(buf, self.w_up.to(dt), ends))
            out = grouped_mm(h, self.w_down.to(dt), ends)
        with span("moe.shared"):
            shared = self._shared(xs)
        with span("moe.combine"):
            picked = out[dest.reshape(-1)].view(b * t, k, d)
            y = torch.einsum("tk,tkd->td", weights, picked.float()) + shared.float()
        return y.to(dt).view(b, t, d)

    def _shared(self, x: torch.Tensor) -> torch.Tensor:
        """The shared experts' SwiGLU on the rows x [N, D]."""
        c = self.config
        dt, mp = c.compute_dtype, c.matmul_precision
        gate = F.silu(quant_matmul(x, self.shared_gate.to(dt), precision=mp))
        up = quant_matmul(x, self.shared_up.to(dt), precision=mp)
        return quant_matmul(gate * up, self.shared_down.to(dt), precision=mp)

    def _count(self, counts: torch.Tensor, ends: torch.Tensor) -> None:
        with torch.no_grad():
            self.expert_load.add_(counts.float())
        if not stepstats.counting():
            return
        n = counts.sum()
        stepstats.count(f"{self.name}.rows", counts)
        stepstats.count(f"{self.name}.max_rows", counts.max())
        stepstats.count(f"{self.name}.padding", ends[-1].long() - n)
        stepstats.count(f"{self.name}.assignments", n)

    @torch.no_grad()
    def after_update(self) -> None:
        """The expert bias's step (torchtitan's ``load_balance_coeff`` rule):
        with c the rows routed to each expert since the last update,
        δ = coeff · sign(mean(c) - c) and bias += δ - mean(δ); then c = 0.
        With ``sum_loads`` c is first summed over every rank (the batch's
        ranks), so that the replicas' biases move alike."""
        c = self.expert_load
        if self.sum_loads:
            dist.all_reduce(c)
        delta = self.config.balance_coeff * torch.sign(c.mean() - c)
        self.expert_bias.add_(delta - delta.mean())
        c.zero_()
