"""DeepSeek-V3 blocks in PyTorch (Kakao's Kanana-2, ``model_type``
``deepseek_v3``): multi-head latent attention (MLA) over a dense SwiGLU FFN
in the first layers and a dropless top-k MoE with shared experts in the
rest. The port's own model: the JAX package has no twin.

For layer ℓ with input h (every RMSNorm in f32 with a learned scale, as
``llama._rmsnorm``; activations in the compute dtype over f32 weights;
H heads, q/k of Dn + Dr = 128 + 64 columns, v of Dv = 128, a latent of
R = 512, no q LoRA):

    a = RMSNorm_in(h)
    q = a·Wq                           [B, H, T, Dn + Dr] → q_nope, q_pe
    [c, k_pe] = a·W_kv_a               c [B, T, R], k_pe [B, T, Dr], one for all heads
    c = RMSNorm_kv(c)                  the latent's own norm, over R
    [k_nope, v] = c·W_kv_b             each [B, H, T, 128]
    q_pe, k_pe = RoPE(q_pe), RoPE(k_pe)   on adjacent pairs (x_2i, x_2i+1)
                                       (HF's ``rope_interleave``), angle
                                       position · θ^(-2i/Dr)
    q = [q_nope, q_pe], k = [k_nope, k_pe broadcast over H]
    o = causal softmax(q·kᵀ · (Dn + Dr)^-1/2)·v
    h = h + o·Wo
    m = RMSNorm_post(h)
    h = h + SwiGLU(m) (the first ``n_dense_layers``), else
        parallel/moe.TokenChoiceMoE(m): Σ_{e ∈ top-k(s + b)} w_e E_e(m) + E_shared(m)

with sigmoid scores s, the top-k of s plus the balancing bias b (one
group: ``noaux_tc`` with ``n_group`` 1), w the selected scores normalised
and scaled, the shared experts one SwiGLU of ``n_shared · d_expert``; an
unscaled embedding, a final RMSNorm and an untied head. The bias moves
after each update (:meth:`DeepseekV3.after_update`, torchtitan's rule, as
AFMoE's). The rotation on adjacent pairs gives the same scores as HF's,
which de-interleaves q_pe and k_pe alike before a half-split rotation.

Attention is the flash operator with q/k 192 wide and v 128
(``kernels/flash_attention``'s (192, 128) instances on the card). During a
capture (runtime/stepstats) the forward opens the spans ``mla.q``,
``mla.kv_down`` (with the latent's norm), ``mla.kv_up``, ``mla.rope`` (with
k's assembly) and ``mla.attention``, and launches two device marks:
``mla_in`` before the projections and ``mla_attn`` after k and v are built,
right before K1, so a device trace bounds the latent path's forward (and its
recompute under remat, which opens both again; the backward of that path is
not bracketed).

``llama.loss_fn`` trains it unchanged (the model keeps llama's
``forward(tokens, return_features)``, ``lm_head``, ``tp_group`` and
``seq_group``). With ``remat_layers`` each layer checkpoints two regions
around its attention, as ``models/afmoe.Block``: K1 runs once per layer per
step, and the recompute of the MoE's region counts no routing twice.
Sharded, it runs over ``data`` and ``fsdp`` only: no ``tensor`` split, no
``sequence`` ring, no exchange over ``expert``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from mpi_operator_tpu_torch.kernels.flash_attention import flash_attention
from mpi_operator_tpu_torch.kernels.quant_matmul import quant_matmul
from mpi_operator_tpu_torch.models.llama import _rmsnorm, _rope_tables
from mpi_operator_tpu_torch.parallel import moe
from mpi_operator_tpu_torch.runtime.stepstats import device_mark, span


@dataclasses.dataclass(frozen=True)
class Config:
    vocab: int = 128_256
    d_model: int = 2048
    n_layers: int = 48
    n_heads: int = 32
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    kv_rank: int = 512  # the latent's width (kv_lora_rank)
    d_ff: int = 6144  # the dense layers' SwiGLU width
    n_dense_layers: int = 1
    n_experts: int = 128
    top_k: int = 6
    d_expert: int = 768
    n_shared_experts: int = 2
    route_scale: float = 2.448
    balance_coeff: float = 1e-3
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    compute_dtype: Any = torch.bfloat16
    # "int8"/"fp8": the dense FFNs' and the shared experts' products quantized
    matmul_precision: str = "bf16"
    remat_layers: bool = False

    def __post_init__(self):
        if self.matmul_precision not in ("bf16", "int8", "fp8"):
            raise ValueError(
                f"matmul_precision={self.matmul_precision!r}; expected bf16|int8|fp8"
            )

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    def moe_config(self) -> moe.TopKConfig:
        return moe.TopKConfig(
            d_model=self.d_model, d_expert=self.d_expert, n_experts=self.n_experts,
            top_k=self.top_k, n_shared=self.n_shared_experts, route_scale=self.route_scale,
            balance_coeff=self.balance_coeff,
            compute_dtype=self.compute_dtype, matmul_precision=self.matmul_precision)


def kanana_2_30b_a3b() -> Config:
    """Kanana-2-30B-A3B's published sizes (48 layers, the first dense)."""
    return Config()


def tiny(vocab: int = 256) -> Config:
    """Test scale with the same structure: 1 dense and 4 MoE layers, 4 heads
    of q/k 16 + 8 and v 16 over a latent of 32, 8 experts at top-2 and 2
    shared, in f32."""
    return Config(
        vocab=vocab, d_model=64, n_layers=5, n_heads=4, qk_nope_dim=16, qk_rope_dim=8,
        v_dim=16, kv_rank=32, d_ff=96, n_dense_layers=1, n_experts=8, top_k=2, d_expert=32,
        compute_dtype=torch.float32,
    )


def rope_interleaved(x, theta: float):
    """RoPE on adjacent pairs of x [..., T, Dr]: (x_2i, x_2i+1) rotated by
    position · θ^(-2i/Dr), each pair left in its place."""
    t, dr = x.shape[-2], x.shape[-1]
    cos, sin = _rope_tables(t, dr, theta, x.dtype, x.device)
    pairs = x.unflatten(-1, (dr // 2, 2))
    x1, x2 = pairs[..., 0], pairs[..., 1]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).flatten(-2)


class Block(nn.Module):
    """One DeepSeek-V3 layer (the module docstring's equations); ``index``
    decides its FFN (dense or MoE)."""

    def __init__(self, config: Config, index: int, device=None):
        super().__init__()
        c = config
        self.config, self.index = c, index

        def p(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        def ones(n):
            return nn.Parameter(torch.ones(n, device=device))

        self.norm_in = ones(c.d_model)
        self.wq = p(c.d_model, c.n_heads * c.qk_dim)
        self.w_kv_a = p(c.d_model, c.kv_rank + c.qk_rope_dim)
        self.kv_norm = ones(c.kv_rank)
        self.w_kv_b = p(c.kv_rank, c.n_heads * (c.qk_nope_dim + c.v_dim))
        self.wo = p(c.n_heads * c.v_dim, c.d_model)
        self.norm_post = ones(c.d_model)
        self.moe: Optional[moe.TokenChoiceMoE] = None
        if index < c.n_dense_layers:
            self.w_gate, self.w_up = p(c.d_model, c.d_ff), p(c.d_model, c.d_ff)
            self.w_down = p(c.d_ff, c.d_model)
        else:
            self.moe = moe.TokenChoiceMoE(c.moe_config(), device, name=f"layers.{index}.moe")

    def forward(self, h):
        c = self.config
        if not (c.remat_layers and torch.is_grad_enabled()):
            q, k, v = self._qkv(h)
            return self._out(h, self._attn(q, k, v), torch.is_grad_enabled())
        # the recompute runs _qkv to its end (no early stop after its last
        # saved tensor), so that it launches the mla_attn mark as well
        with set_checkpoint_early_stop(False):
            q, k, v = checkpoint(self._qkv, h, use_reentrant=False)
        attn = self._attn(q, k, v)
        calls = []

        def out(h, attn):  # its second call is the backward's recompute
            calls.append(None)
            return self._out(h, attn, len(calls) == 1)

        return checkpoint(out, h, attn, use_reentrant=False)

    def _qkv(self, h):
        """(q, k, v) heads-major: q and k [B, H, T, Dn + Dr], v [B, H, T, Dv]."""
        c = self.config
        dt = c.compute_dtype
        mark = h.device if h.is_cuda else None
        device_mark(mark, "mla_in")
        a = _rmsnorm(h, self.norm_in, c.norm_eps)
        with span("mla.q"):
            q = torch.einsum("btd,dhx->bhtx", a, self.wq.to(dt).unflatten(-1, (c.n_heads, -1)))
            q_nope, q_pe = q.split([c.qk_nope_dim, c.qk_rope_dim], dim=-1)
        with span("mla.kv_down"):
            latent, k_pe = (a @ self.w_kv_a.to(dt)).split([c.kv_rank, c.qk_rope_dim], dim=-1)
            latent = _rmsnorm(latent.contiguous(), self.kv_norm, c.norm_eps)
        with span("mla.kv_up"):
            kv = torch.einsum("btr,rhx->bhtx", latent,
                              self.w_kv_b.to(dt).unflatten(-1, (c.n_heads, -1)))
            k_nope, v = kv.split([c.qk_nope_dim, c.v_dim], dim=-1)
        with span("mla.rope"):
            q = torch.cat([q_nope, rope_interleaved(q_pe, c.rope_theta)], dim=-1)
            k_pe = rope_interleaved(k_pe[:, None], c.rope_theta)  # [B, 1, T, Dr]
            k = torch.cat([k_nope, k_pe.expand(-1, c.n_heads, -1, -1)], dim=-1)
        device_mark(mark, "mla_attn")
        return q, k, v.contiguous()

    def _attn(self, q, k, v):
        with span("mla.attention"):
            return flash_attention(q, k, v, causal=True, scale=self.config.qk_dim ** -0.5,
                                   layout="bhtd")

    def _out(self, h, attn, count: bool):
        c = self.config
        dt, mp = c.compute_dtype, c.matmul_precision
        wo3 = self.wo.to(dt).unflatten(0, (c.n_heads, c.v_dim))
        h = h + torch.einsum("bhtx,hxd->btd", attn, wo3)
        m = _rmsnorm(h, self.norm_post, c.norm_eps)
        if self.moe is not None:
            return h + self.moe(m, count=count)
        gate = nn.functional.silu(quant_matmul(m, self.w_gate.to(dt), precision=mp))
        up = quant_matmul(m, self.w_up.to(dt), precision=mp)
        return h + quant_matmul(gate * up, self.w_down.to(dt), precision=mp)


class DeepseekV3(nn.Module):
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
        # rows in f32 (as models/afmoe)
        x = self.embed[tokens].to(dt)
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
        """Only ``data`` and ``fsdp``: the heads have no ``tensor`` split, the
        attention no ``sequence`` ring and the experts no exchange over
        ``expert`` (``ValueError``, by name). The expert biases' step sums
        the rows routed on every rank, as AFMoE's."""
        from mpi_operator_tpu_torch.runtime.topology import AXIS_SEQ, AXIS_TENSOR, mesh_sizes

        sizes = mesh_sizes(mesh)
        for axis in (AXIS_SEQ, AXIS_TENSOR):
            if sizes.get(axis, 1) > 1:
                raise ValueError(f"DeepSeek-V3 does not run over {axis}={sizes[axis]}")
        moe.check_mesh(mesh)
        for m in self.moe_layers():
            m.sum_loads = math.prod(sizes.values()) > 1


_LAYER_AXES = {
    "norm_in": ("stats",), "wq": ("embed", "heads"), "w_kv_a": ("embed", None),
    "kv_norm": ("stats",), "w_kv_b": (None, "heads"), "wo": ("heads", "embed"),
    "norm_post": ("stats",),
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
         device: Union[str, torch.device] = "cuda") -> DeepseekV3:
    """A model with every matrix and the embedding normal(0, 0.02) (the
    published ``initializer_range``), drawn from ``generator`` (on
    ``device``) in parameter order; norm scales 1, expert bias 0."""
    model = DeepseekV3(config, device=device)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.normal_(0.0, 0.02, generator=generator)
    return model


def apply(model: DeepseekV3, tokens, *, return_features: bool = False):
    """tokens [B, T] → logits [B, T, vocab] f32, or features [B, T, d_model]."""
    return model(tokens, return_features=return_features)


def param_count(config: Config) -> int:
    c = config
    attn = (c.d_model * c.n_heads * c.qk_dim + c.d_model * (c.kv_rank + c.qk_rope_dim)
            + c.kv_rank * c.n_heads * (c.qk_nope_dim + c.v_dim) + c.n_heads * c.v_dim * c.d_model)
    norms = 2 * c.d_model + c.kv_rank
    expert = 3 * c.d_model * c.d_expert
    moe_layer = c.d_model * c.n_experts + (c.n_experts + c.n_shared_experts) * expert
    n_moe = c.n_layers - c.n_dense_layers
    return (2 * c.vocab * c.d_model + c.d_model + c.n_layers * (attn + norms)
            + c.n_dense_layers * 3 * c.d_model * c.d_ff + n_moe * moe_layer)
