"""Llama-family decoder in PyTorch.

Port of ``mpi_operator_tpu/models/llama.py``: the same config fields and
presets, the same parameter shapes (weights as ``[in, out]``, so ``y @ w``
as in the JAX package) and the same rounding points:

- RMSNorm in f32, times the f32 scale, cast back to the activation dtype;
- RoPE with the half-split rotation, tables built in f32 and cast to the
  compute dtype *before* the multiply (rotating in f32 drifts from the JAX
  package in bf16);
- the embedding table cast to the compute dtype before the gather;
- logits cast to f32 before the log-softmax.

The JAX package stacks the layers on a leading axis for ``lax.scan``; here
they are an ``nn.ModuleList`` and ``params_from_jax`` / ``params_to_jax``
convert between the two. ``remat_layers`` checkpoints each layer around its
flash attention (:class:`DecoderLayer`): as under the JAX package's policy
(``save_only_these_names("flash_o", "flash_lse")``), K1 runs once per layer
per step, its (o, lse) kept for the backward, and the projections, RoPE,
norms and FFN are recomputed. The flash inputs (q, k, v) are kept too,
where JAX recomputes them: a selective-checkpoint policy that keeps only
(o, lse) intercepts every op of the layer in Python and cost 10–15 ms of
host time a step on the card, more than K1's second launch saves
(PERF.md, §6).

Sharded over a mesh (parallel/sharding.py calls :func:`set_parallel`), a
rank computes on its own shards, as Megatron-LM does:

- ``tensor``: the q/k/v and gate/up products are column-parallel (this
  rank's heads and FFN columns) after ``copy_to_tp`` of the normed input;
  ``wo`` and ``w_down`` are row-parallel, their partial outputs summed by
  ``reduce_from_tp`` (parallel/collectives.py). The embedding and
  ``lm_head`` are split over the vocabulary: a token outside this rank's
  rows embeds to zero before the sum, and the cross-entropy takes its max,
  its sum of exps and the target's logit over the ranks' vocab blocks
  (:func:`_token_ll`); full-vocab logits never exist on one rank;
- ``sequence``: the rank holds one contiguous block of T; RoPE runs at the
  block's global positions and attention is the ring
  (parallel/ring_attention.py), which sits between the two checkpointed
  regions of the layer as K1 does, so the recompute runs no ring transfer.
  The batch carries the block's next-token targets and validity mask
  (ops/data.py), and the loss is the block's share of its rows' mean.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from mpi_operator_tpu_torch.kernels.flash_attention import flash_attention
from mpi_operator_tpu_torch.kernels.quant_matmul import quant_matmul
from mpi_operator_tpu_torch.kernels.rmsnorm import rmsnorm
from mpi_operator_tpu_torch.parallel import collectives
from mpi_operator_tpu_torch.parallel.collectives import copy_to_tp, reduce_from_tp
from mpi_operator_tpu_torch.parallel.ring_attention import dense_attention, ring_attention


@dataclasses.dataclass(frozen=True)
class Config:
    vocab: int = 128_256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 14_336
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    compute_dtype: Any = torch.bfloat16
    # "auto" and "flash": the flash kernels (CUDA on the card, their plain
    # versions on the CPU); "dense": the quadratic oracle, small cases only
    attention_impl: str = "auto"
    # "int8"/"fp8": the FFN products' forward quantized (kernels/quant_matmul)
    matmul_precision: str = "bf16"
    remat_layers: bool = False

    def __post_init__(self):
        if self.attention_impl not in ("auto", "dense", "flash"):
            raise ValueError(
                f"attention_impl={self.attention_impl!r}; expected auto|dense|flash"
            )
        if self.matmul_precision not in ("bf16", "int8", "fp8"):
            raise ValueError(
                f"matmul_precision={self.matmul_precision!r}; expected bf16|int8|fp8"
            )

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def llama3_8b() -> Config:
    return Config()


def bench_single_chip() -> Config:
    """Llama-3-architecture decoder (~0.79B params): GQA 4:1, d_ff 3.5x."""
    return Config(
        vocab=32_768, d_model=2048, n_layers=12, n_heads=16, n_kv_heads=4,
        head_dim=128, d_ff=7168, remat_layers=True,
    )


def bench_long_context() -> Config:
    """bench_single_chip with a 16k vocab, for sequences above 8k."""
    return dataclasses.replace(bench_single_chip(), vocab=16_384)


def tiny(vocab: int = 256) -> Config:
    """Test-scale config with the same architecture (GQA ratio included)."""
    return Config(
        vocab=vocab, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, rope_theta=10_000.0,
    )


# Logical axes of one decoder layer's parameters (≙ the JAX ``logical_axes``
# without its leading layer-stack axis, which is always replicated there).
_LAYER_AXES = {
    "attn_norm": ("stats",),
    "wq": ("embed", "heads"),
    "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"),
    "wo": ("heads", "embed"),
    "mlp_norm": ("stats",),
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
}


def logical_axes(config: Config) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes of every parameter, keyed by its state-dict name
    (parallel/sharding.py maps them to mesh axes)."""
    axes = {"embed": ("vocab", "embed"), "final_norm": ("stats",), "lm_head": ("embed", "vocab")}
    for i in range(config.n_layers):
        axes.update({f"layers.{i}.{name}": a for name, a in _LAYER_AXES.items()})
    return axes


def _rmsnorm(x, scale, eps: float):
    """RMSNorm in f32 with the f32 scale, cast back to x's dtype: K-rms on
    the card, its plain version elsewhere (kernels/rmsnorm.py)."""
    return rmsnorm(x, _local(scale), eps)


def _rope_tables(t: int, dh: int, theta: float, dtype, device, offset: int = 0):
    """cos/sin [T, Dh/2] at positions offset..offset+T-1, built in f32 and
    cast to ``dtype``."""
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)
    pos = torch.arange(offset, offset + t, dtype=torch.float32, device=device)
    ang = pos[:, None] * freqs[None, :]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope_bhtd(x, theta: float, offset: int = 0):
    """RoPE, heads-major layout: x [B,H,T,Dh] at positions offset.."""
    cos, sin = _rope_tables(x.shape[2], x.shape[-1], theta, x.dtype, x.device, offset)
    return _rotate(x, cos, sin)


def _local(p):
    """This rank's shard of a parameter split over ``tensor`` (a DTensor;
    ``to_local`` is differentiable), the parameter itself otherwise."""
    return p.to_local() if isinstance(p, DTensor) else p


def _vocab_shard_ids(ids, v_local: int, tp_group):
    """(ids moved into this rank's block of the vocabulary and clamped to
    it, and whether each id lies in the block)."""
    local = ids - collectives.axis_index(tp_group) * v_local
    inside = (local >= 0) & (local < v_local)
    return local.clamp(0, v_local - 1), inside


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: GQA attention with RoPE, then a SwiGLU FFN.

    With ``remat_layers`` the layer checkpoints its own body in two regions,
    the attention inputs (norm, q/k/v projections, RoPE) and the output
    (wo, residual, norm, FFN), with the flash operator between them: the
    backward recomputes both regions but not K1, whose (o, lse) the
    operator saved. The regions sit inside the module, so FSDP2's unshard
    and reshard hooks on the layer stay outside what is recomputed.

    ``tp_group`` and ``seq_group`` (None: no such axis) are set by
    :func:`set_parallel`."""

    def __init__(self, config: Config, device=None):
        super().__init__()
        c = config
        self.config = c
        self.tp_group = self.seq_group = None

        def p(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.attn_norm = nn.Parameter(torch.ones(c.d_model, device=device))
        self.wq = p(c.d_model, c.q_dim)
        self.wk = p(c.d_model, c.kv_dim)
        self.wv = p(c.d_model, c.kv_dim)
        self.wo = p(c.q_dim, c.d_model)
        self.mlp_norm = nn.Parameter(torch.ones(c.d_model, device=device))
        self.w_gate = p(c.d_model, c.d_ff)
        self.w_up = p(c.d_model, c.d_ff)
        self.w_down = p(c.d_ff, c.d_model)

    def forward(self, h):
        c = self.config
        if not (c.remat_layers and torch.is_grad_enabled()):
            return self._out(h, self._attn(*self._qkv(h)))
        q, k, v = checkpoint(self._qkv, h, use_reentrant=False)
        attn = self._attn(q, k, v)
        return checkpoint(self._out, h, attn, use_reentrant=False)

    def _qkv(self, h):
        c = self.config
        dt = c.compute_dtype
        y = copy_to_tp(_rmsnorm(h, self.attn_norm, c.norm_eps), self.tp_group)
        # heads-major end to end: project straight into the kernels'
        # [B,H,T,Dh] layout (and fold the output back through wo in _out);
        # under ``tensor`` the weights' shards hold this rank's heads
        wq3 = _local(self.wq).to(dt).unflatten(-1, (-1, c.head_dim))
        wk3 = _local(self.wk).to(dt).unflatten(-1, (-1, c.head_dim))
        wv3 = _local(self.wv).to(dt).unflatten(-1, (-1, c.head_dim))
        pos = 0
        if self.seq_group is not None:  # this rank's block starts at a global position
            pos = collectives.axis_index(self.seq_group) * h.shape[1]
        q = _rope_bhtd(torch.einsum("btd,dhx->bhtx", y, wq3), c.rope_theta, pos)
        k = _rope_bhtd(torch.einsum("btd,dhx->bhtx", y, wk3), c.rope_theta, pos)
        v = torch.einsum("btd,dhx->bhtx", y, wv3)
        return q, k, v

    def _attn(self, q, k, v):
        c = self.config
        scale = c.head_dim ** -0.5
        if self.seq_group is not None:
            return ring_attention(q, k, v, self.seq_group, causal=True, scale=scale,
                                  layout="bhtd")
        if c.attention_impl == "dense":
            return dense_attention(
                *(x.transpose(1, 2) for x in (q, k, v)), causal=True, scale=scale
            ).transpose(1, 2)
        return flash_attention(q, k, v, causal=True, scale=scale, layout="bhtd")

    def _out(self, h, attn):
        c = self.config
        dt = c.compute_dtype
        tp = self.tp_group
        wo3 = _local(self.wo).to(dt).unflatten(0, (-1, c.head_dim))
        h = h + reduce_from_tp(torch.einsum("bhtx,hxd->btd", attn, wo3), tp)
        y = copy_to_tp(_rmsnorm(h, self.mlp_norm, c.norm_eps), tp)
        # the FFN products: bf16 plain; int8/fp8 with the forward quantized
        # and the backward at full precision. w_down is row-parallel: its
        # partial products are summed over ``tensor`` (its scales and
        # accumulator too, when quantized) inside quant_matmul
        mp = c.matmul_precision
        gate = nn.functional.silu(quant_matmul(y, _local(self.w_gate).to(dt), precision=mp))
        up = quant_matmul(y, _local(self.w_up).to(dt), precision=mp)
        return h + quant_matmul(gate * up, _local(self.w_down).to(dt), precision=mp,
                                tp_group=tp)


class Llama(nn.Module):
    """tokens [B,T] → logits [B,T,vocab] f32 (or final-norm features).
    Under ``tensor`` the logits are this rank's block of the vocabulary."""

    def __init__(self, config: Config, device=None):
        super().__init__()
        c = config
        self.config = c
        self.tp_group = self.seq_group = None
        self.embed = nn.Parameter(torch.empty(c.vocab, c.d_model, device=device))
        self.layers = nn.ModuleList(DecoderLayer(c, device) for _ in range(c.n_layers))
        self.final_norm = nn.Parameter(torch.ones(c.d_model, device=device))
        self.lm_head = nn.Parameter(torch.empty(c.d_model, c.vocab, device=device))

    def forward(self, tokens, return_features: bool = False):
        c = self.config
        dt = c.compute_dtype
        x = self._embed(tokens, _local(self.embed).to(dt))
        for layer in self.layers:
            x = layer(x)
        x = _rmsnorm(x, self.final_norm, c.norm_eps)
        if return_features:
            return x
        return (copy_to_tp(x, self.tp_group) @ _local(self.lm_head).to(dt)).float()

    # -- the sharding protocol (parallel/sharding.py) -----------------------

    def logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        return logical_axes(self.config)

    def fsdp_units(self):
        """FSDP2's units below the root: one per decoder layer."""
        return list(self.layers)

    def set_parallel(self, mesh) -> None:
        """Check that ``tensor`` divides the heads, and take the ``tensor``
        and ``sequence`` process groups."""
        from mpi_operator_tpu_torch.parallel.sharding import check_head_split
        from mpi_operator_tpu_torch.runtime.topology import (
            AXIS_SEQ,
            AXIS_TENSOR,
            axis_group,
            mesh_sizes,
        )

        c = self.config
        check_head_split(c.n_heads, c.n_kv_heads, mesh_sizes(mesh).get(AXIS_TENSOR, 1))
        set_parallel(self, tp_group=axis_group(mesh, AXIS_TENSOR),
                     seq_group=axis_group(mesh, AXIS_SEQ))

    def _embed(self, tokens, table):
        """The rows of ``tokens``. Under ``tensor`` each rank holds a block of
        the vocabulary and looks up the tokens in it (zeros for the others),
        and the ranks' rows are summed."""
        if self.tp_group is None:
            return table[tokens]
        ids, inside = _vocab_shard_ids(tokens, table.shape[0], self.tp_group)
        return reduce_from_tp(table[ids] * inside[..., None].to(table.dtype), self.tp_group)


def set_parallel(model: Llama, *, tp_group=None, seq_group=None) -> None:
    """Give the model the process groups of its ``tensor`` and ``sequence``
    axes (None: no such axis); parallel/sharding.py calls it."""
    for m in (model, *model.layers):
        m.tp_group, m.seq_group = tp_group, seq_group


def init(
    config: Config,
    generator: torch.Generator,
    device: Union[str, torch.device] = "cuda",
) -> Llama:
    """A model with the JAX package's init distribution (normal weights with
    fan-in scales, unit norms), drawn from ``generator``, which must live on
    ``device``. The draws differ from ``jax.random``'s: tests that compare
    the two convert one set of weights with ``params_from_jax``."""
    c = config
    model = Llama(c, device=device)
    s_d, s_ff, s_q = c.d_model ** -0.5, c.d_ff ** -0.5, c.q_dim ** -0.5
    with torch.no_grad():
        model.embed.normal_(0.0, 1.0, generator=generator)
        for layer in model.layers:
            for name, s in (("wq", s_d), ("wk", s_d), ("wv", s_d), ("wo", s_q),
                            ("w_gate", s_d), ("w_up", s_d), ("w_down", s_ff)):
                getattr(layer, name).normal_(0.0, s, generator=generator)
        model.lm_head.normal_(0.0, s_d, generator=generator)
    return model


def apply(model: Llama, tokens, *, return_features: bool = False):
    """tokens [B,T] → logits [B,T,vocab] f32, or features [B,T,d_model]."""
    return model(tokens, return_features=return_features)


def _token_ll(logits, y, tp_group):
    """log softmax(logits)[y] in f32. Under ``tensor`` the logits are this
    rank's block of the vocabulary: the max (detached: any shift gives the
    same value) and the sum of exps are taken over the ranks, and the
    target's logit comes from the rank whose block holds it."""
    if tp_group is None:
        return torch.log_softmax(logits, dim=-1).gather(-1, y[..., None])[..., 0]
    m = collectives.pmax(logits.detach().amax(-1), tp_group)
    sum_exp = reduce_from_tp(torch.exp(logits - m[..., None]).sum(-1), tp_group)
    ids, inside = _vocab_shard_ids(y, logits.shape[-1], tp_group)
    target = torch.where(inside, logits.gather(-1, ids[..., None])[..., 0], 0.0)
    return reduce_from_tp(target, tp_group) - m - torch.log(sum_exp)


def _chunk_nll(xc, head, yc, vc, tp_group=None):
    logits = (copy_to_tp(xc, tp_group) @ _local(head).to(xc.dtype)).float()
    return torch.where(vc, _token_ll(logits, yc, tp_group), 0.0).sum()


def loss_fn(model: Llama, batch: Dict[str, torch.Tensor], *, ce_chunk: int = 2048):
    """Next-token cross-entropy; position t predicts token t+1, the last
    position is dropped. Above ``ce_chunk`` positions the loss runs over
    checkpointed sequence chunks, so the f32 logits of one chunk exist at a
    time (the JAX package's roll-shift and validity mask).

    Over a ``sequence`` axis the batch is this rank's block of T with its
    ``targets`` and ``valid`` mask (ops/data.py), and the loss is the
    block's sum over the count of its rows' predictions: the blocks' losses
    sum to the rows' mean (ops/trainer.py scales them by the sequence size
    and averages)."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    tp = model.tp_group
    if "targets" in batch:
        y, valid = batch["targets"], batch["valid"]
        n_seq = 1 if model.seq_group is None else collectives.axis_size(model.seq_group)
        n = t * n_seq - 1
    elif model.seq_group is not None:
        raise ValueError("a sequence-sharded model needs the batch's targets and valid "
                         "mask (ops/data.py make_global_batch with the mesh)")
    else:
        y, valid, n = None, None, t - 1  # real prediction positions
    if t - 1 <= ce_chunk:
        logits = apply(model, tokens)
        if y is None:  # the whole sequence: drop the last position
            return -_token_ll(logits[:, :-1], tokens[:, 1:], tp).mean()
        return -torch.where(valid, _token_ll(logits, y, tp), 0.0).sum() / (b * n)

    feats = apply(model, tokens, return_features=True)
    if y is None:
        y = torch.roll(tokens, -1, dims=1)
        valid = (torch.arange(t, device=tokens.device) < n)[None, :]
    total = feats.new_zeros((), dtype=torch.float32)
    for c0 in range(0, t, ce_chunk):
        args = (feats[:, c0:c0 + ce_chunk], model.lm_head, y[:, c0:c0 + ce_chunk],
                valid[:, c0:c0 + ce_chunk], tp)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            total = total + _chunk_nll(*args)
    return -total / (b * n)


def param_count(config: Config) -> int:
    c = config
    per_layer = (
        c.d_model * (c.q_dim + 2 * c.kv_dim)
        + c.q_dim * c.d_model
        + 3 * c.d_model * c.d_ff
        + 2 * c.d_model
    )
    return c.vocab * c.d_model + c.n_layers * per_layer + c.d_model + c.d_model * c.vocab


def flops_per_token(config: Config, seq_len: int) -> float:
    """Forward matmul FLOPs per token (2·MACs); attention term included."""
    c = config
    matmul_params = (
        c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model + 3 * c.d_model * c.d_ff
    )
    per_layer = 2 * matmul_params + 4 * seq_len * c.q_dim  # scores + PV
    return float(c.n_layers * per_layer + 2 * c.d_model * c.vocab)


# The JAX init tree's leaves under "layers" are stacked [n_layers, ...]; each
# entry maps (JAX path) → name on a DecoderLayer.
_LAYER_LEAVES = {
    ("attn_norm", "scale"): "attn_norm",
    ("wq", "w"): "wq",
    ("wk", "w"): "wk",
    ("wv", "w"): "wv",
    ("wo", "w"): "wo",
    ("mlp_norm", "scale"): "mlp_norm",
    ("w_gate", "w"): "w_gate",
    ("w_up", "w"): "w_up",
    ("w_down", "w"): "w_down",
}
_TOP_LEAVES = {
    ("embed", "w"): "embed",
    ("final_norm", "scale"): "final_norm",
    ("lm_head", "w"): "lm_head",
}


def params_from_jax(
    tree: Dict[str, Any], device: Optional[Union[str, torch.device]] = None
) -> Dict[str, torch.Tensor]:
    """The JAX ``init`` tree (leaves as numpy arrays) → a state dict for
    :class:`Llama` (``model.load_state_dict(params_from_jax(tree))``)."""
    out = {}
    for (group, leaf), name in _TOP_LEAVES.items():
        out[name] = torch.from_numpy(np.array(tree[group][leaf])).to(device)
    layers = tree["layers"]
    n_layers = np.asarray(layers["wq"]["w"]).shape[0]
    for (group, leaf), name in _LAYER_LEAVES.items():
        stacked = np.asarray(layers[group][leaf])
        for i in range(n_layers):
            out[f"layers.{i}.{name}"] = torch.from_numpy(np.array(stacked[i])).to(device)
    return out


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: a :class:`Llama` state dict (or
    gradients keyed the same way) → the JAX tree layout, as numpy arrays."""
    def arr(name):
        return state[name].detach().cpu().numpy()

    tree: Dict[str, Any] = {
        group: {leaf: arr(name)} for (group, leaf), name in _TOP_LEAVES.items()
    }
    n_layers = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("layers."))
    tree["layers"] = {}
    for (group, leaf), name in _LAYER_LEAVES.items():
        tree["layers"][group] = {
            leaf: np.stack([arr(f"layers.{i}.{name}") for i in range(n_layers)])
        }
    return tree
