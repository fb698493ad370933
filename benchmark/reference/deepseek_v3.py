"""A plain float32 DeepSeek-V3 decoder (multi-head latent attention over a
top-k MoE, HF ``DeepseekV3``) and its training step.

The equations, for layer i with input x (every RMSNorm with a learned scale;
H heads, q/k of qk_nope_head_dim + qk_rope_head_dim, v of v_head_dim, a
latent of kv_lora_rank, no q LoRA):

    a = rmsnorm_in(x)
    q = a Wq, per head [q_nope, q_pe]
    [c, k_pe] = a W_kv_a; c = rmsnorm_kv(c)       k_pe: one for all heads
    [k_nope, v] = c W_kv_b, per head
    q_pe, k_pe = rope(q_pe), rope(k_pe)           HF's rope_interleave: the
        adjacent pairs gathered into two halves, then the halves rotated
    o = causal attention([q_nope, q_pe], [k_nope, k_pe], v;
                         scale (qk_nope_head_dim + qk_rope_head_dim)^-1/2)
    x = x + o Wo
    m = rmsnorm_post(x)
    x = x + swiglu(m) in the first first_k_dense_replace layers; else
        s = sigmoid(m Wr); S = top-k of s + b (b: the expert bias, no
        gradient; noaux_tc with one group); f = sum over e in S of w_e E_e(m)
        + E_shared(m), w_e = routed_scaling_factor s_e / sum_S s
        (norm_topk_prob), E(x) = (silu(x W1) * x W3) W2, the shared experts
        one SwiGLU of n_shared_experts x moe_intermediate_size

with an unscaled embedding, a final RMSNorm, an untied head, and next-token
cross-entropy over the B x (T - 1) predictions. After each update, every
MoE layer's bias moves by delta - mean(delta), delta = balance_coeff x
sign(mean(c) - c), c the rows routed to each expert in that step's forward
(the configuration's ``assumed``: DeepSeek-V3's bias update speed, applied
as torchtitan does). The biases start where that rule leaves them once
routing is even (:func:`balanced_biases`), and the learning rate warms up
linearly from 0.

It fits a card by blocks: the forward keeps each layer's input, the
backward runs each layer again with autograd; attention runs in
checkpointed blocks of query rows over the keys they see, and the experts
one at a time over the rows routed to them, each checkpointed
(``reference.afmoe``'s). Nothing here is the program's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from benchmark.reference import optim
from benchmark.reference.afmoe import attention, even_bias, learning_rate, moe, swiglu
from benchmark.reference.decoder import rmsnorm

ATTN_LEAVES = ("norm_in", "wq", "w_kv_a", "kv_norm", "w_kv_b", "wo", "norm_post")
DENSE_LEAVES = ("w_gate", "w_up", "w_down")
MOE_LEAVES = tuple("moe." + n for n in ("router", "w_gate", "w_up", "w_down", "shared_gate",
                                       "shared_up", "shared_down"))


class Shape:
    def __init__(self, config: Dict[str, Any]):
        self.d = int(config["hidden_size"])
        self.h = int(config["num_attention_heads"])
        self.nope = int(config["qk_nope_head_dim"])
        self.rope = int(config["qk_rope_head_dim"])
        self.dv = int(config["v_head_dim"])
        self.rank = int(config["kv_lora_rank"])
        self.ff = int(config["intermediate_size"])
        self.fe = int(config["moe_intermediate_size"])
        self.vocab = int(config["vocab_size"])
        self.layers = int(config["num_hidden_layers"])
        self.dense = int(config["first_k_dense_replace"])
        self.experts = int(config["n_routed_experts"])
        self.top_k = int(config["num_experts_per_tok"])
        self.shared = int(config["n_shared_experts"])
        self.route_scale = float(config["routed_scaling_factor"])
        self.route_norm = bool(config["norm_topk_prob"])
        self.interleave = bool(config["rope_interleave"])
        self.theta = float(config["rope_theta"])
        self.eps = float(config["rms_norm_eps"])
        self.coeff = float(config["assumed"]["balance_coeff"])
        wants = {"scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
                 "topk_group": 1, "q_lora_rank": None, "rope_scaling": None, "moe_layer_freq": 1}
        for key, want in wants.items():
            if config[key] != want:
                raise ValueError(f"{key} {config[key]!r}: this reference is for {want!r}")

    @property
    def qk(self) -> int:
        return self.nope + self.rope

    def leaves(self, i: int):
        return ATTN_LEAVES + (DENSE_LEAVES if i < self.dense else MOE_LEAVES)


def rope(x, theta: float, interleave: bool):
    """HF DeepseekV3's rotary embedding of x [B, H, T, Dr] at positions
    0..T-1: with ``interleave`` the adjacent pairs are first gathered into
    two halves (``apply_rotary_pos_emb_interleave``), then the halves are
    rotated by position x theta^(-2i/Dr)."""
    b, h, t, d = x.shape
    if interleave:
        x = x.view(b, h, t, d // 2, 2).transpose(4, 3).reshape(b, h, t, d)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    emb = torch.cat([ang, ang], dim=-1)
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * emb.cos() + rotated * emb.sin()


def _attend(x, w: Dict[str, torch.Tensor], s: Shape):
    """(x after the attention's residual, the FFN's normed input); ``w``
    holds the layer's leaves by their short names."""
    b, t, _ = x.shape
    a = rmsnorm(x, w["norm_in"], s.eps)
    q = (a @ w["wq"]).view(b, t, s.h, s.qk).transpose(1, 2)
    q_nope, q_pe = q.split([s.nope, s.rope], dim=-1)
    c, k_pe = (a @ w["w_kv_a"]).split([s.rank, s.rope], dim=-1)
    kv = (rmsnorm(c, w["kv_norm"], s.eps) @ w["w_kv_b"]).view(b, t, s.h, s.nope + s.dv)
    k_nope, v = kv.transpose(1, 2).split([s.nope, s.dv], dim=-1)
    q_pe = rope(q_pe, s.theta, s.interleave)
    k_pe = rope(k_pe.view(b, 1, t, s.rope), s.theta, s.interleave)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, s.h, t, s.rope)], dim=-1)
    o = attention(q, k, v.contiguous(), s.qk ** -0.5)
    x = x + o.transpose(1, 2).reshape(b, t, s.h * s.dv) @ w["wo"]
    return x, rmsnorm(x, w["norm_post"], s.eps)


def _ffn(x, m, w: Dict[str, torch.Tensor], s: Shape, i: int, bias: Optional[torch.Tensor]):
    """(output, rows routed to each expert or None) of layer ``i``'s FFN
    half on :func:`_attend`'s (x, m)."""
    if i < s.dense:
        return x + swiglu(m, w["w_gate"], w["w_up"], w["w_down"]), None
    f, counts = moe(m, w, bias, s)
    return x + f, counts


def layer(x, w: Dict[str, torch.Tensor], s: Shape, i: int, bias: Optional[torch.Tensor]):
    """(output, rows routed to each expert or None) of layer ``i``."""
    return _ffn(*_attend(x, w, s), w, s, i, bias)


def _layer_leaves(w, s: Shape, i: int) -> Dict[str, torch.Tensor]:
    return {k: w[f"layers.{i}.{k}"] for k in s.leaves(i)}


def balanced_biases(w: Dict[str, torch.Tensor], tokens: torch.Tensor,
                    config: Dict[str, Any]) -> Dict[int, torch.Tensor]:
    """Each MoE layer's expert bias at the start of training: the one under
    which the forward of ``tokens`` [B, T] (the first batch) at the weights
    ``w`` routes evenly (``reference.afmoe.even_bias``), solved layer by
    layer, each MoE layer run with its bias before the next is solved (the
    configuration's ``assumed`` ``expert_bias_init``)."""
    s = Shape(config)
    biases: Dict[int, torch.Tensor] = {}
    with torch.no_grad():
        x = w["embed"][tokens]
        for i in range(s.layers):
            lw = _layer_leaves(w, s, i)
            x, m = _attend(x, lw, s)
            if i >= s.dense:
                scores = torch.sigmoid(m.reshape(-1, s.d) @ lw["moe.router"])
                biases[i] = even_bias(scores, s.top_k)
                del scores
            x, _ = _ffn(x, m, lw, s, i, biases.get(i))
    return biases


def logits(w: Dict[str, torch.Tensor], tokens: torch.Tensor, s: Shape,
           biases: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The forward's logits [B, T, vocab] of ``tokens`` [B, T]."""
    x = w["embed"][tokens]
    for i in range(s.layers):
        x, _ = layer(x, _layer_leaves(w, s, i), s, i, biases.get(i))
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
    with torch.no_grad():
        x = w["embed"][tokens]
        for i in range(s.layers):
            inputs.append(x)
            x, c = layer(x, _layer_leaves(w, s, i), s, i, biases.get(i))
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
    g_embed.index_add_(0, tokens.reshape(-1), gx.reshape(-1, s.d))
    grads["embed"] = g_embed
    return float(loss), grads, counts


def train(w: Dict[str, torch.Tensor], batches: List[torch.Tensor], config: Dict[str, Any],
          on_grads: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
          biases: Optional[Dict[int, torch.Tensor]] = None) -> List[float]:
    """Train ``w`` (float32 leaves, updated in place) one step per batch with
    the configuration's optimizer (at ``learning_rate``), then move each MoE
    layer's expert bias (``biases``, updated in place; zeros by default,
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
