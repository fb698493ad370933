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
convert between the two. ``remat_layers`` checkpoints each layer with
``torch.utils.checkpoint`` (so K1 runs twice per layer).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mpi_operator_tpu_torch.kernels.flash_attention import flash_attention
from mpi_operator_tpu_torch.parallel.ring_attention import dense_attention


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
    # "int8"/"fp8" FFN products are the quant_matmul slice, not ported yet
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
        if self.matmul_precision != "bf16":
            raise NotImplementedError(
                f"matmul_precision={self.matmul_precision!r} needs the quantized "
                "FFN products (kernels/quant_matmul), which a later slice ports"
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


def _rmsnorm(x, scale, eps: float):
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def _rope_tables(t: int, dh: int, theta: float, dtype, device):
    """cos/sin [T, Dh/2], built in f32 and cast to ``dtype``."""
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope_bhtd(x, theta: float):
    """RoPE, heads-major layout: x [B,H,T,Dh]."""
    cos, sin = _rope_tables(x.shape[2], x.shape[-1], theta, x.dtype, x.device)
    return _rotate(x, cos, sin)


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: GQA attention with RoPE, then a SwiGLU FFN."""

    def __init__(self, config: Config, device=None):
        super().__init__()
        c = config
        self.config = c

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
        dt = c.compute_dtype
        y = _rmsnorm(h, self.attn_norm, c.norm_eps)
        scale = c.head_dim ** -0.5
        # heads-major end to end: project straight into the kernels'
        # [B,H,T,Dh] layout and fold the output back through wo
        wq3 = self.wq.to(dt).reshape(-1, c.n_heads, c.head_dim)
        wk3 = self.wk.to(dt).reshape(-1, c.n_kv_heads, c.head_dim)
        wv3 = self.wv.to(dt).reshape(-1, c.n_kv_heads, c.head_dim)
        q = _rope_bhtd(torch.einsum("btd,dhx->bhtx", y, wq3), c.rope_theta)
        k = _rope_bhtd(torch.einsum("btd,dhx->bhtx", y, wk3), c.rope_theta)
        v = torch.einsum("btd,dhx->bhtx", y, wv3)
        if c.attention_impl == "dense":
            attn = dense_attention(
                *(x.transpose(1, 2) for x in (q, k, v)), causal=True, scale=scale
            ).transpose(1, 2)
        else:
            attn = flash_attention(q, k, v, causal=True, scale=scale, layout="bhtd")
        wo3 = self.wo.to(dt).reshape(c.n_heads, c.head_dim, -1)
        h = h + torch.einsum("bhtx,hxd->btd", attn, wo3)
        y = _rmsnorm(h, self.mlp_norm, c.norm_eps)
        gate = nn.functional.silu(y @ self.w_gate.to(dt))
        up = y @ self.w_up.to(dt)
        return h + (gate * up) @ self.w_down.to(dt)


class Llama(nn.Module):
    """tokens [B,T] → logits [B,T,vocab] f32 (or final-norm features)."""

    def __init__(self, config: Config, device=None):
        super().__init__()
        c = config
        self.config = c
        self.embed = nn.Parameter(torch.empty(c.vocab, c.d_model, device=device))
        self.layers = nn.ModuleList(DecoderLayer(c, device) for _ in range(c.n_layers))
        self.final_norm = nn.Parameter(torch.ones(c.d_model, device=device))
        self.lm_head = nn.Parameter(torch.empty(c.d_model, c.vocab, device=device))

    def forward(self, tokens, return_features: bool = False):
        c = self.config
        dt = c.compute_dtype
        x = self.embed.to(dt)[tokens]
        for layer in self.layers:
            if c.remat_layers and torch.is_grad_enabled():
                x = checkpoint(layer, x, use_reentrant=False)
            else:
                x = layer(x)
        x = _rmsnorm(x, self.final_norm, c.norm_eps)
        if return_features:
            return x
        return (x @ self.lm_head.to(dt)).float()


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


def _chunk_nll(xc, head, yc, vc):
    logits = (xc @ head.to(xc.dtype)).float()
    ll = torch.log_softmax(logits, dim=-1).gather(-1, yc[..., None])[..., 0]
    return torch.where(vc, ll, 0.0).sum()


def loss_fn(model: Llama, batch: Dict[str, torch.Tensor], *, ce_chunk: int = 2048):
    """Next-token cross-entropy; position t predicts token t+1, the last
    position is dropped. Above ``ce_chunk`` positions the loss runs over
    checkpointed sequence chunks, so the f32 logits of one chunk exist at a
    time (the JAX package's roll-shift and validity mask)."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    if t - 1 <= ce_chunk:
        logits = apply(model, tokens)
        lp = torch.log_softmax(logits[:, :-1], dim=-1)
        return -lp.gather(-1, tokens[:, 1:, None]).mean()

    feats = apply(model, tokens, return_features=True)
    y = torch.roll(tokens, -1, dims=1)
    n = t - 1  # real prediction positions
    total = feats.new_zeros((), dtype=torch.float32)
    for c0 in range(0, t, ce_chunk):
        xc, yc = feats[:, c0:c0 + ce_chunk], y[:, c0:c0 + ce_chunk]
        vc = (torch.arange(c0, c0 + xc.shape[1], device=tokens.device) < n)[None, :]
        if torch.is_grad_enabled():
            total = total + checkpoint(
                _chunk_nll, xc, model.lm_head, yc, vc, use_reentrant=False
            )
        else:
            total = total + _chunk_nll(xc, model.lm_head, yc, vc)
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
