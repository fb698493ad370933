"""A plain float32 AFMoE (Arcee's Trinity) decoder and its training step.

The equations, for layer i with input x (every RMSNorm with a learned scale):

    a = rmsnorm_in(x); q = a Wq, k = a Wk, v = a Wv (heads of head_dim)
    q, k = rmsnorm_q(q), rmsnorm_k(k), over head_dim (QK-norm)
    sliding layer: q, k = rope(q, k); key j visible to query i iff
                   i - sliding_window < j <= i
    full layer: no rope (NoPE), causal
    o = attention(q, k, v; scale head_dim^-1/2) * sigmoid(a Wg)
    x = x + rmsnorm_post_attn(o Wo)
    m = rmsnorm_pre_mlp(x)
    f = swiglu(m) in the first num_dense_layers; else
        s = sigmoid(m Wr); S = top-k of s + b (b: the expert bias, no gradient)
        f = sum over e in S of w_e E_e(m) + E_shared(m), w_e = route_scale
            s_e / sum_S s (route_norm), E(x) = (silu(x W1) * x W3) W2
    x = x + rmsnorm_post_mlp(f)

with the embedding times sqrt(hidden_size) (mup_enabled), a final RMSNorm,
an untied head, and next-token cross-entropy over the B x (T - 1)
predictions. After each update, every MoE layer's bias moves by
delta - mean(delta), delta = load_balance_coeff * sign(mean(c) - c), c the
rows routed to each expert in that step's forward. The biases start where
that rule leaves them once routing is even (``balanced_biases``), and the
learning rate warms up linearly from 0 (``learning_rate``). The published config
gives the sizes, the layer types, the router's settings and the balance
coefficient; the output gate, QK-norm, NoPE, the four norms, the embedding
scale, the weights scaling the experts' outputs and the bias rule follow the
upstream description of the model (the configuration's ``assumed`` block),
unconfirmed against its code.

It fits a card by blocks, as ``reference.decoder`` does: the forward keeps
each layer's input, the backward runs each layer again with autograd;
attention runs in checkpointed blocks of query rows over the keys they see;
the experts run one at a time, each checkpointed. Nothing here is the
program's.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import optim
from benchmark.reference.decoder import rmsnorm, rope

ATTN_LEAVES = ("norm_in", "wq", "wk", "wv", "wg", "wo", "q_norm", "k_norm", "norm_post_attn",
               "norm_pre_mlp", "norm_post_mlp")
DENSE_LEAVES = ("w_gate", "w_up", "w_down")
MOE_LEAVES = tuple("moe." + n for n in ("router", "w_gate", "w_up", "w_down", "shared_gate",
                                       "shared_up", "shared_down"))
_ELEMS_PER_BLOCK = 1 << 28  # f32 scores of one attention block: 1 GiB


class Shape:
    def __init__(self, config: Dict[str, Any]):
        self.d = int(config["hidden_size"])
        self.h = int(config["num_attention_heads"])
        self.kv = int(config["num_key_value_heads"])
        self.dh = int(config["head_dim"])
        self.ff = int(config["intermediate_size"])
        self.fe = int(config["moe_intermediate_size"])
        self.vocab = int(config["vocab_size"])
        self.layers = int(config["num_hidden_layers"])
        self.dense = int(config["num_dense_layers"])
        self.experts = int(config["num_experts"])
        self.top_k = int(config["num_experts_per_tok"])
        self.shared = int(config["num_shared_experts"])
        self.route_scale = float(config["route_scale"])
        self.route_norm = bool(config["route_norm"])
        self.window = int(config["sliding_window"])
        self.types = list(config["layer_types"])[:self.layers]
        self.theta = float(config["rope_theta"])
        self.eps = float(config["rms_norm_eps"])
        self.coeff = float(config["load_balance_coeff"])
        self.mup = bool(config["mup_enabled"])
        if config["score_func"] != "sigmoid":
            raise ValueError(f"score_func {config['score_func']!r}: this reference is sigmoid's")

    def leaves(self, i: int) -> Tuple[str, ...]:
        return ATTN_LEAVES + (DENSE_LEAVES if i < self.dense else MOE_LEAVES)

    def sliding(self, i: int) -> bool:
        return self.types[i] == "sliding_attention"


def _attention_block(qb, k, v, q0: int, k0: int, scale: float, window: int):
    """Rows q0.. of attention against keys k0..q0 + rows - 1, the causal mask
    and (window above 0) the window's lower edge applied."""
    s = (qb * scale) @ k.transpose(-1, -2)
    qi = torch.arange(q0, q0 + qb.shape[2], device=qb.device)[:, None]
    kj = torch.arange(k0, k0 + k.shape[2], device=qb.device)[None, :]
    seen = qi >= kj
    if window:
        seen &= qi - kj < window
    return torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1) @ v


def attention(q, k, v, scale: float, window: int = 0):
    """Causal attention, windowed when ``window`` is above 0; q [B, H, T, Dh],
    k/v [B, Hkv, T, Dh], query head h reading kv head h // (H / Hkv). Each
    block of query rows sees only the keys its rows see, and is recomputed
    in the backward."""
    b, h, t, _ = q.shape
    g = h // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    block = max(16, min(t, _ELEMS_PER_BLOCK // (b * h * t)))
    outs = []
    for q0 in range(0, t, block):
        end = min(t, q0 + block)
        k0 = max(0, q0 - window + 1) if window else 0
        outs.append(checkpoint(_attention_block, q[:, :, q0:end], k[:, :, k0:end],
                               v[:, :, k0:end], q0, k0, scale, window, use_reentrant=False))
    return torch.cat(outs, dim=2)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def moe(m, w: Dict[str, torch.Tensor], bias: torch.Tensor, s: Shape):
    """(f, rows routed to each expert) of the MoE FFN on m [B, T, D]; the
    experts run one at a time over the rows routed to them."""
    x = m.reshape(-1, s.d)
    scores = torch.sigmoid(x @ w["moe.router"])
    chosen = torch.topk(scores.detach() + bias, s.top_k, dim=-1).indices
    weights = scores.gather(1, chosen)
    if s.route_norm:
        weights = weights / weights.sum(-1, keepdim=True)
    weights = weights * s.route_scale
    f = swiglu(x, w["moe.shared_gate"], w["moe.shared_up"], w["moe.shared_down"])
    experts = zip(w["moe.w_gate"].unbind(0), w["moe.w_up"].unbind(0), w["moe.w_down"].unbind(0))
    for e, (wg, wu, wd) in enumerate(experts):
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        if rows.numel():
            y = checkpoint(swiglu, x[rows], wg, wu, wd, use_reentrant=False)
            f = f.index_add(0, rows, y * weights[rows, slot, None])
    counts = torch.bincount(chosen.reshape(-1), minlength=s.experts).float()
    return f.view_as(m), counts


def _attend(x, w: Dict[str, torch.Tensor], s: Shape, i: int):
    """(x after the attention's residual, the FFN's normed input) of layer
    ``i``; ``w`` holds its leaves by their short names."""
    b, t, _ = x.shape
    a = rmsnorm(x, w["norm_in"], s.eps)

    def heads(wt, n):
        return (a @ wt).view(b, t, n, s.dh).transpose(1, 2)

    q = rmsnorm(heads(w["wq"], s.h), w["q_norm"], s.eps)
    k = rmsnorm(heads(w["wk"], s.kv), w["k_norm"], s.eps)
    if s.sliding(i):
        q, k = rope(q, s.theta), rope(k, s.theta)
    o = attention(q, k, heads(w["wv"], s.kv), s.dh ** -0.5, s.window if s.sliding(i) else 0)
    o = o.transpose(1, 2).reshape(b, t, s.h * s.dh) * torch.sigmoid(a @ w["wg"])
    x = x + rmsnorm(o @ w["wo"], w["norm_post_attn"], s.eps)
    return x, rmsnorm(x, w["norm_pre_mlp"], s.eps)


def _ffn(x, m, w: Dict[str, torch.Tensor], s: Shape, i: int, bias: Optional[torch.Tensor]):
    """(output, rows routed to each expert or None) of layer ``i``'s FFN
    half on :func:`_attend`'s (x, m)."""
    counts = None
    if i < s.dense:
        f = swiglu(m, w["w_gate"], w["w_up"], w["w_down"])
    else:
        f, counts = moe(m, w, bias, s)
    return x + rmsnorm(f, w["norm_post_mlp"], s.eps), counts


def layer(x, w: Dict[str, torch.Tensor], s: Shape, i: int, bias: Optional[torch.Tensor]):
    """(output, rows routed to each expert or None) of layer ``i``; ``w``
    holds its leaves by their short names."""
    return _ffn(*_attend(x, w, s, i), w, s, i, bias)


def even_bias(scores: torch.Tensor, top_k: int, rounds: int = 400) -> torch.Tensor:
    """An expert bias [E] under which the top-k of ``scores`` [N, E] + bias
    spreads the N·k assignments evenly over the experts: ``rounds`` steps
    of the balancing rule (bias += δ − mean(δ), δ = η·sign(mean(c) − c), c
    the rows each expert gets), η shrinking geometrically from 2e-2 to
    1e-5."""
    e = scores.shape[1]
    bias = torch.zeros(e, device=scores.device)
    for r in range(rounds):
        chosen = torch.topk(scores + bias, top_k, dim=-1).indices
        c = torch.bincount(chosen.reshape(-1), minlength=e).float()
        delta = 2e-2 * (5e-4 ** (r / max(rounds - 1, 1))) * torch.sign(c.mean() - c)
        bias += delta - delta.mean()
    return bias


def balanced_biases(w: Dict[str, torch.Tensor], tokens: torch.Tensor,
                    config: Dict[str, Any]) -> Dict[int, torch.Tensor]:
    """Each MoE layer's expert bias at the start of training: the one under
    which the forward of ``tokens`` [B, T] (the first batch) at the weights
    ``w`` routes evenly (:func:`even_bias`), solved layer by layer, each
    MoE layer run with its bias before the next is solved. It stands for the
    state a pretraining run's balancing rule has reached (the
    configuration's ``assumed`` ``expert_bias_init``)."""
    s = Shape(config)
    biases: Dict[int, torch.Tensor] = {}
    with torch.no_grad():
        x = w["embed"][tokens] * (math.sqrt(s.d) if s.mup else 1.0)
        for i in range(s.layers):
            lw = {k: w[f"layers.{i}.{k}"] for k in s.leaves(i)}
            x, m = _attend(x, lw, s, i)
            if i >= s.dense:
                scores = torch.sigmoid(m.reshape(-1, s.d) @ lw["moe.router"])
                biases[i] = even_bias(scores, s.top_k)
                del scores
            x, _ = _ffn(x, m, lw, s, i, biases.get(i))
    return biases


def learning_rate(opt: Dict[str, Any], count: int) -> float:
    """The learning rate of update ``count`` (1 for the first): with
    ``warmup_steps`` W above 0 it rises linearly, lr · min(count − 1, W) / W
    (optax's linear warmup from 0, which the first update takes at 0)."""
    lr, warmup = float(opt["learning_rate"]), int(opt.get("warmup_steps", 0))
    return lr * min(count - 1, warmup) / warmup if warmup else lr


def logits(w: Dict[str, torch.Tensor], tokens: torch.Tensor, s: Shape,
           biases: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The forward's logits [B, T, vocab] of ``tokens`` [B, T]."""
    x = w["embed"][tokens] * (math.sqrt(s.d) if s.mup else 1.0)
    for i in range(s.layers):
        x, _ = layer(x, {k: w[f"layers.{i}.{k}"] for k in s.leaves(i)}, s, i, biases.get(i))
    return rmsnorm(x, w["final_norm"], s.eps) @ w["lm_head"]


def new_biases(s: Shape, device) -> Dict[int, torch.Tensor]:
    """Each MoE layer's expert bias at init: zeros."""
    return {i: torch.zeros(s.experts, device=device) for i in range(s.dense, s.layers)}


def _leaves(w, names):
    return {n: w[n].detach().requires_grad_() for n in names}


def loss_and_grads(w: Dict[str, torch.Tensor], tokens: torch.Tensor, s: Shape,
                   biases: Dict[int, torch.Tensor]):
    """(loss, gradients by leaf name, rows routed to each expert by MoE
    layer) of one batch ``tokens`` [B, T]."""
    b, t = tokens.shape
    n = b * (t - 1)
    inputs: List[Optional[torch.Tensor]] = []
    counts: Dict[int, torch.Tensor] = {}
    scale = math.sqrt(s.d) if s.mup else 1.0
    with torch.no_grad():
        x = w["embed"][tokens] * scale
        for i in range(s.layers):
            inputs.append(x)
            x, c = layer(x, {k: w[f"layers.{i}.{k}"] for k in s.leaves(i)}, s, i, biases.get(i))
            if c is not None:
                counts[i] = c
    grads: Dict[str, torch.Tensor] = {}
    x = x.detach().requires_grad_()
    top = _leaves(w, ("final_norm", "lm_head"))
    loss = torch.zeros((), device=x.device)
    with torch.enable_grad():
        y = rmsnorm(x, top["final_norm"], s.eps)
        yd = y.detach().requires_grad_()
        chunk = max(1, (1 << 13) // b)  # about 8k positions of logits at a time
        for c0 in range(0, t - 1, chunk):
            c1 = min(t - 1, c0 + chunk)
            logp = torch.log_softmax(yd[:, c0:c1] @ top["lm_head"], dim=-1)
            part = -logp.gather(-1, tokens[:, c0 + 1:c1 + 1, None]).sum() / n
            part.backward()
            loss += part.detach()
        y.backward(yd.grad)
    grads.update({k: v.grad for k, v in top.items()})
    gx = x.grad
    for i in reversed(range(s.layers)):
        xi = inputs[i].requires_grad_()
        inputs[i] = None
        lw = _leaves(w, [f"layers.{i}.{k}" for k in s.leaves(i)])
        with torch.enable_grad():
            out, _ = layer(xi, {k: lw[f"layers.{i}.{k}"] for k in s.leaves(i)}, s, i,
                           biases.get(i))
            out.backward(gx)
        grads.update({k: v.grad for k, v in lw.items()})
        gx = xi.grad
        del out, xi
    g_embed = torch.zeros_like(w["embed"])
    g_embed.index_add_(0, tokens.reshape(-1), gx.reshape(-1, s.d) * scale)
    grads["embed"] = g_embed
    return float(loss), grads, counts


def train(w: Dict[str, torch.Tensor], batches: List[torch.Tensor], config: Dict[str, Any],
          on_grads: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
          biases: Optional[Dict[int, torch.Tensor]] = None) -> List[float]:
    """Train ``w`` (float32 leaves, updated in place) one step per batch with
    the configuration's optimizer (at :func:`learning_rate`), then move each
    MoE layer's expert bias (``biases``, updated in place; zeros by default,
    :func:`balanced_biases` as the benchmark starts them); returns each
    step's loss. ``on_grads(step, grads)`` sees each step's gradients as
    the optimizer gets them (after clipping)."""
    s = Shape(config)
    opt = config["assumed"]
    state = optim.init_state(w, opt)
    if biases is None:
        biases = new_biases(s, w["embed"].device)
    losses = []
    for step, tokens in enumerate(batches, start=1):
        loss, grads, counts = loss_and_grads(w, tokens, s, biases)
        if float(opt.get("grad_clip_norm", 0.0)) > 0:
            optim.clip_by_global_norm(grads, float(opt["grad_clip_norm"]))
        if on_grads is not None:
            on_grads(step, grads)
        optim.update(w, grads, state, step,
                     dict(opt, learning_rate=learning_rate(opt, step)))
        for i, c in counts.items():
            delta = s.coeff * torch.sign(c.mean() - c)
            biases[i] += delta - delta.mean()
        losses.append(loss)
        del grads
    return losses
