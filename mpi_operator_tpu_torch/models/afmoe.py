"""AFMoE (Arcee's Trinity models) in PyTorch: a decoder of gated GQA attention,
windowed and global, over dense SwiGLU FFNs in its first layers and a
dropless top-k MoE with a shared expert in the rest. The port's own model:
the JAX package has no twin.

For layer ℓ with input h (every RMSNorm in f32 with a learned scale, as
``llama._rmsnorm``; activations in the compute dtype over f32 weights):

    a = RMSNorm_in(h)
    q = a·Wq, k = a·Wk, v = a·Wv          heads-major [B, H, T, Dh]
    q, k = RMSNorm_q(q), RMSNorm_k(k)     over Dh, one scale each (QK-norm)
    windowed layer: q, k = RoPE(q, k)     llama's half-split rotation;
                    key j visible to query i iff i - W < j <= i
    global layer (every ``global_every``-th): no RoPE, causal
    o = attention(q, k, v) ⊙ sigmoid(a·Wg)
    h = h + RMSNorm_post_attn(o·Wo)
    m = RMSNorm_pre_mlp(h)
    f = SwiGLU(m) (the first ``n_dense_layers``), else the MoE of
        parallel/moe.TokenChoiceMoE: Σ_{e ∈ top-k(s + b)} w_e E_e(m) + E_shared(m)
    h = h + RMSNorm_post_mlp(f)

with the embedding scaled by √d_model (muP) and an untied head after a
final RMSNorm. Of these the published config gives the sizes, the window,
the global period, the dense layers, the router (sigmoid, normalised,
scaled) and that muP is on; the output gate, QK-norm, NoPE on the global
layers, the four norms, the √d embedding scale, the weights scaling the
experts' outputs and the bias update (:meth:`AFMoE.after_update`,
``ops/trainer.py`` calls it after each update) follow the upstream
description of the model, not its code, which was not read.

``llama.loss_fn`` trains it unchanged (the model keeps llama's
``forward(tokens, return_features)``, ``lm_head``, ``tp_group`` and
``seq_group``). With ``remat_layers`` each layer checkpoints two regions
around its attention, as ``llama.DecoderLayer``: K1 runs once per layer
per step, and the recompute of the MoE's region counts no routing twice.
Sharded, it runs over ``data`` and ``fsdp`` only: no ``tensor`` split, no
ring for the window, no exchange over ``expert``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mpi_operator_tpu_torch.kernels.flash_attention import flash_attention
from mpi_operator_tpu_torch.kernels.quant_matmul import quant_matmul
from mpi_operator_tpu_torch.models.llama import _rmsnorm, _rope_bhtd
from mpi_operator_tpu_torch.parallel import moe


@dataclasses.dataclass(frozen=True)
class Config:
    vocab: int = 200_192
    d_model: int = 2048
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 4
    head_dim: int = 128
    d_ff: int = 6144  # the dense layers' SwiGLU width
    n_dense_layers: int = 2
    n_experts: int = 128
    top_k: int = 8
    d_expert: int = 1024
    n_shared_experts: int = 1
    route_scale: float = 2.826
    balance_coeff: float = 1e-3
    window: int = 2048
    global_every: int = 4  # layer i is global iff (i + 1) % global_every == 0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    compute_dtype: Any = torch.bfloat16
    # "int8"/"fp8": the dense FFNs' and the shared expert's products quantized
    matmul_precision: str = "bf16"
    remat_layers: bool = False

    def __post_init__(self):
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

    def is_global(self, layer: int) -> bool:
        return (layer + 1) % self.global_every == 0

    def moe_config(self) -> moe.TopKConfig:
        return moe.TopKConfig(
            d_model=self.d_model, d_expert=self.d_expert, n_experts=self.n_experts,
            top_k=self.top_k, n_shared=self.n_shared_experts, route_scale=self.route_scale,
            balance_coeff=self.balance_coeff,
            compute_dtype=self.compute_dtype, matmul_precision=self.matmul_precision)


def trinity_mini() -> Config:
    """Trinity-Mini's published sizes (26B-A3B, 32 layers)."""
    return Config()


def tiny(vocab: int = 256) -> Config:
    """Test scale with the same structure: 2 dense and 4 MoE layers, windowed
    but for layer 3 (S S S G S S), window 8, 8 experts at top-2 and a
    shared one, in f32."""
    return Config(
        vocab=vocab, d_model=64, n_layers=6, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, n_dense_layers=2, n_experts=8, top_k=2, d_expert=32, route_scale=2.0,
        window=8, compute_dtype=torch.float32,
    )


class Block(nn.Module):
    """One AFMoE layer (the module docstring's equations); ``index`` decides
    its attention (windowed or global) and FFN (dense or MoE)."""

    def __init__(self, config: Config, index: int, device=None):
        super().__init__()
        c = config
        self.config, self.index = c, index
        self.is_global = c.is_global(index)

        def p(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        def ones(n):
            return nn.Parameter(torch.ones(n, device=device))

        self.norm_in = ones(c.d_model)
        self.wq, self.wk, self.wv = p(c.d_model, c.q_dim), p(c.d_model, c.kv_dim), p(
            c.d_model, c.kv_dim)
        self.wg = p(c.d_model, c.q_dim)
        self.wo = p(c.q_dim, c.d_model)
        self.q_norm, self.k_norm = ones(c.head_dim), ones(c.head_dim)
        self.norm_post_attn, self.norm_pre_mlp, self.norm_post_mlp = (
            ones(c.d_model), ones(c.d_model), ones(c.d_model))
        self.moe: Optional[moe.TokenChoiceMoE] = None
        if index < c.n_dense_layers:
            self.w_gate, self.w_up = p(c.d_model, c.d_ff), p(c.d_model, c.d_ff)
            self.w_down = p(c.d_ff, c.d_model)
        else:
            self.moe = moe.TokenChoiceMoE(c.moe_config(), device, name=f"layers.{index}.moe")

    def forward(self, h):
        c = self.config
        if not (c.remat_layers and torch.is_grad_enabled()):
            q, k, v, g = self._qkv(h)
            return self._out(h, self._attn(q, k, v), g, torch.is_grad_enabled())
        q, k, v, g = checkpoint(self._qkv, h, use_reentrant=False)
        attn = self._attn(q, k, v)
        calls = []

        def out(h, attn, g):  # its second call is the backward's recompute
            calls.append(None)
            return self._out(h, attn, g, len(calls) == 1)

        return checkpoint(out, h, attn, g, use_reentrant=False)

    def _qkv(self, h):
        """(q, k, v) heads-major after QK-norm and (windowed layers) RoPE, and
        the output gate sigmoid(a·Wg) in q's layout."""
        c = self.config
        dt = c.compute_dtype
        a = _rmsnorm(h, self.norm_in, c.norm_eps)

        def heads(w):
            return torch.einsum("btd,dhx->bhtx", a, w.to(dt).unflatten(-1, (-1, c.head_dim)))

        q = _rmsnorm(heads(self.wq), self.q_norm, c.norm_eps)
        k = _rmsnorm(heads(self.wk), self.k_norm, c.norm_eps)
        if not self.is_global:
            q, k = _rope_bhtd(q, c.rope_theta), _rope_bhtd(k, c.rope_theta)
        return q, k, heads(self.wv), torch.sigmoid(heads(self.wg))

    def _attn(self, q, k, v):
        c = self.config
        return flash_attention(q, k, v, causal=True, scale=c.head_dim ** -0.5, layout="bhtd",
                               window=0 if self.is_global else c.window)

    def _out(self, h, attn, g, count: bool):
        c = self.config
        dt, mp = c.compute_dtype, c.matmul_precision
        wo3 = self.wo.to(dt).unflatten(0, (-1, c.head_dim))
        o = torch.einsum("bhtx,hxd->btd", attn * g, wo3)
        h = h + _rmsnorm(o, self.norm_post_attn, c.norm_eps)
        m = _rmsnorm(h, self.norm_pre_mlp, c.norm_eps)
        if self.moe is not None:
            f = self.moe(m, count=count)
        else:
            gate = nn.functional.silu(quant_matmul(m, self.w_gate.to(dt), precision=mp))
            up = quant_matmul(m, self.w_up.to(dt), precision=mp)
            f = quant_matmul(gate * up, self.w_down.to(dt), precision=mp)
        return h + _rmsnorm(f, self.norm_post_mlp, c.norm_eps)


class AFMoE(nn.Module):
    """tokens [B, T] → logits [B, T, vocab] f32 (or final-norm features)."""

    def __init__(self, config: Config, device=None):
        super().__init__()
        c = config
        self.config = c
        self.tp_group = self.seq_group = None  # llama.loss_fn's: no such axis here
        self.embed = nn.Parameter(torch.empty(c.vocab, c.d_model, device=device))
        self.layers = nn.ModuleList(Block(c, i, device) for i in range(c.n_layers))
        self.final_norm = nn.Parameter(torch.ones(c.d_model, device=device))
        self.lm_head = nn.Parameter(torch.empty(c.d_model, c.vocab, device=device))

    def forward(self, tokens, return_features: bool = False):
        c = self.config
        dt = c.compute_dtype
        # gathered in f32 and cast after, so that the backward sums each id's
        # rows in f32: a frequent id's thousands of rows lose their sum in bf16
        x = self.embed[tokens].to(dt) * math.sqrt(c.d_model)  # muP
        for layer in self.layers:
            x = layer(x)
        x = _rmsnorm(x, self.final_norm, c.norm_eps)
        if return_features:
            return x
        return (x @ self.lm_head.to(dt)).float()

    def moe_layers(self):
        return [layer.moe for layer in self.layers if layer.moe is not None]

    def after_update(self) -> None:
        """After each optimizer update: every MoE layer's expert-bias step."""
        for m in self.moe_layers():
            m.after_update()

    # -- the sharding protocol (parallel/sharding.py) -----------------------

    def logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        return logical_axes(self.config)

    def fsdp_units(self):
        return list(self.layers)

    def set_parallel(self, mesh) -> None:
        """Only ``data`` and ``fsdp``: the window has no ring, the heads no
        ``tensor`` split and the experts no exchange (``ValueError``). Every
        rank then holds other rows of the batch, and the expert biases' step
        sums the rows routed on every rank (the trainer's gradient mean is
        over every rank too), so that each rank's biases stay the same."""
        from mpi_operator_tpu_torch.runtime.topology import AXIS_SEQ, AXIS_TENSOR, mesh_sizes

        sizes = mesh_sizes(mesh)
        for axis in (AXIS_SEQ, AXIS_TENSOR):
            if sizes.get(axis, 1) > 1:
                raise ValueError(f"AFMoE does not run over {axis}={sizes[axis]}")
        moe.check_mesh(mesh)
        for m in self.moe_layers():
            m.sum_loads = math.prod(sizes.values()) > 1


_LAYER_AXES = {
    "norm_in": ("stats",), "wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"), "wg": ("embed", "heads"), "wo": ("heads", "embed"),
    "q_norm": ("stats",), "k_norm": ("stats",), "norm_post_attn": ("stats",),
    "norm_pre_mlp": ("stats",), "norm_post_mlp": ("stats",),
}
_DENSE_AXES = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
_MOE_AXES = {
    "router": ("embed", None), "w_gate": ("expert", "embed", "mlp"),
    "w_up": ("expert", "embed", "mlp"), "w_down": ("expert", "mlp", "embed"),
    "shared_gate": ("embed", "mlp"), "shared_up": ("embed", "mlp"),
    "shared_down": ("mlp", "embed"),
}


def logical_axes(config: Config) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes of every parameter, keyed by its state-dict name."""
    axes = {"embed": ("vocab", "embed"), "final_norm": ("stats",), "lm_head": ("embed", "vocab")}
    for i in range(config.n_layers):
        p = f"layers.{i}."
        axes.update({p + n: a for n, a in _LAYER_AXES.items()})
        if i < config.n_dense_layers:
            axes.update({p + n: a for n, a in _DENSE_AXES.items()})
        else:
            axes.update({p + "moe." + n: a for n, a in _MOE_AXES.items()})
    return axes


def init(config: Config, generator: torch.Generator,
         device: Union[str, torch.device] = "cuda") -> AFMoE:
    """A model with every matrix and the embedding normal(0, 0.02) (the
    published ``initializer_range``), drawn from ``generator`` (on
    ``device``) in parameter order; norm scales 1, expert bias 0."""
    model = AFMoE(config, device=device)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.normal_(0.0, 0.02, generator=generator)
    return model


def apply(model: AFMoE, tokens, *, return_features: bool = False):
    """tokens [B, T] → logits [B, T, vocab] f32, or features [B, T, d_model]."""
    return model(tokens, return_features=return_features)


def param_count(config: Config) -> int:
    c = config
    attn = c.d_model * (2 * c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
    norms = 4 * c.d_model + 2 * c.head_dim
    dense = 3 * c.d_model * c.d_ff
    expert = 3 * c.d_model * c.d_expert
    moe_layer = c.d_model * c.n_experts + (c.n_experts + c.n_shared_experts) * expert
    n_moe = c.n_layers - c.n_dense_layers
    return (2 * c.vocab * c.d_model + c.d_model + c.n_layers * (attn + norms)
            + c.n_dense_layers * dense + n_moe * moe_layer)
