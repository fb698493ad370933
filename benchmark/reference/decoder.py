"""A plain float32 Mistral-style decoder and its training step.

The equations are Mistral-7B's (and Llama's): pre-norm RMSNorm with a
learned scale, rotary embeddings on the rotate-half convention (frequency
``theta ** (-i / (head_dim / 2))``), grouped-query attention with a causal
mask and scale ``head_dim ** -0.5``, a SwiGLU FFN
``w_down(silu(x w_gate) * (x w_up))``, a final RMSNorm, an untied LM head,
and next-token cross-entropy averaged over the B x (T - 1) predictions.
Weights are ``[in, out]`` (``y = x @ w``) under the names the benchmark
draws them by.

It fits a card by blocks: the forward keeps only each layer's input, and
the backward runs each layer again with autograd before its own backward;
attention runs in blocks of query rows, each recomputed in the backward;
the loss runs in chunks of positions. Over several cards
(:func:`train_data_parallel`) each rank takes its share of the rows and
every rank holds the whole model. Nothing here is the program's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import optim

LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")
_ELEMS_PER_BLOCK = 1 << 28  # f32 scores of one attention block: 1 GiB


class Shape:
    def __init__(self, config: Dict[str, Any]):
        self.d = int(config["hidden_size"])
        self.h = int(config["num_attention_heads"])
        self.kv = int(config["num_key_value_heads"])
        self.dh = int(config["assumed"]["head_dim"])
        self.ff = int(config["intermediate_size"])
        self.vocab = int(config["vocab_size"])
        self.layers = int(config["num_hidden_layers"])
        self.theta = float(config["rope_theta"])
        self.eps = float(config["rms_norm_eps"])


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """Rotate-half RoPE of x [B, H, T, Dh] at positions 0..T-1 (angles in
    float64, then float32)."""
    t, dh = x.shape[2], x.shape[3]
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention_block(qb, k, v, q0: int, scale: float):
    """Rows q0.. of causal attention against keys 0..q0 + rows - 1: the
    keys before q0 are all visible, the last square is masked above its
    diagonal."""
    s = (qb * scale) @ k.transpose(-1, -2)
    rows = qb.shape[2]
    above = torch.ones(rows, rows, dtype=torch.bool, device=qb.device).triu(1)
    s[..., q0:].masked_fill_(above, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def attention(q, k, v, scale: float):
    """Causal attention, q [B, H, T, Dh], k/v [B, Hkv, T, Dh]; query head h
    reads kv head h // (H / Hkv). Blocks of query rows see the keys up to
    their last row, and each block is recomputed in the backward."""
    b, h, t, _ = q.shape
    g = h // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    block = max(16, min(t, _ELEMS_PER_BLOCK // (b * h * t)))
    outs = []
    for q0 in range(0, t, block):
        end = min(t, q0 + block)
        outs.append(checkpoint(_attention_block, q[:, :, q0:end], k[:, :, :end],
                               v[:, :, :end], q0, scale, use_reentrant=False))
    return torch.cat(outs, dim=2)


def layer(x, w: Dict[str, torch.Tensor], s: Shape):
    """One decoder layer; ``w`` holds its leaves by their short names."""
    b, t, _ = x.shape
    y = rmsnorm(x, w["attn_norm"], s.eps)
    q = (y @ w["wq"]).view(b, t, s.h, s.dh).transpose(1, 2)
    k = (y @ w["wk"]).view(b, t, s.kv, s.dh).transpose(1, 2)
    v = (y @ w["wv"]).view(b, t, s.kv, s.dh).transpose(1, 2)
    o = attention(rope(q, s.theta), rope(k, s.theta), v, s.dh ** -0.5)
    x = x + o.transpose(1, 2).reshape(b, t, s.h * s.dh) @ w["wo"]
    y = rmsnorm(x, w["mlp_norm"], s.eps)
    return x + (F.silu(y @ w["w_gate"]) * (y @ w["w_up"])) @ w["w_down"]


def _leaves(w, names):
    return {n: w[n].detach().requires_grad_() for n in names}


def loss_and_grads(w: Dict[str, torch.Tensor], tokens: torch.Tensor, s: Shape,
                   sink: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None):
    """(loss, gradients by leaf name) of one batch ``tokens`` [B, T]. With
    ``sink``, each group of gradients goes to it as the backward produces
    it (the head's, each layer's from the last, the embedding's), and the
    returned gradients are empty."""
    b, t = tokens.shape
    n = b * (t - 1)
    inputs: List[Optional[torch.Tensor]] = []
    with torch.no_grad():
        x = w["embed"][tokens]
        for i in range(s.layers):
            inputs.append(x)
            x = layer(x, {k: w[f"layers.{i}.{k}"] for k in LAYER_LEAVES}, s)
    grads: Dict[str, torch.Tensor] = {}
    sink = sink or grads.update
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
    sink({k: v.grad for k, v in top.items()})
    gx = x.grad
    for i in reversed(range(s.layers)):
        xi = inputs[i].requires_grad_()
        inputs[i] = None
        lw = _leaves(w, [f"layers.{i}.{k}" for k in LAYER_LEAVES])
        with torch.enable_grad():
            out = layer(xi, {k: lw[f"layers.{i}.{k}"] for k in LAYER_LEAVES}, s)
            out.backward(gx)
        sink({k: v.grad for k, v in lw.items()})
        gx = xi.grad
        del out, xi
    g_embed = torch.zeros_like(w["embed"])
    g_embed.index_add_(0, tokens.reshape(-1), gx.reshape(-1, s.d))
    sink({"embed": g_embed})
    return float(loss), grads


def train(w: Dict[str, torch.Tensor], batches: List[torch.Tensor], config: Dict[str, Any],
          on_grads: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None
          ) -> List[float]:
    """Train ``w`` (float32 leaves, updated in place) one step per batch with
    the configuration's optimizer; returns each step's loss.
    ``on_grads(step, grads)`` sees each step's gradients as the optimizer
    gets them (after clipping)."""
    s = Shape(config)
    opt = config["assumed"]
    state = optim.init_state(w, opt)
    losses = []
    for step, tokens in enumerate(batches, start=1):
        loss, grads = loss_and_grads(w, tokens, s)
        if float(opt.get("grad_clip_norm", 0.0)) > 0:
            optim.clip_by_global_norm(grads, float(opt["grad_clip_norm"]))
        if on_grads is not None:
            on_grads(step, grads)
        optim.update(w, grads, state, step, opt)
        losses.append(loss)
        del grads
    return losses


def train_data_parallel(w: Dict[str, torch.Tensor], batches: List[torch.Tensor],
                        config: Dict[str, Any],
                        on_grad: Optional[Callable[[int, str, torch.Tensor], None]] = None
                        ) -> Tuple[List[float], List[float]]:
    """:func:`train` of a global batch whose rows are split over the ranks of
    the default process group: every rank holds the whole ``w`` and passes
    its own rows (as many on every rank). Each gradient is averaged over the
    ranks as the backward produces it; each rank keeps the optimizer state
    of its own 1/N of every leaf (flattened) and updates that part, and the
    parts are then gathered, so that every rank holds the whole updated
    ``w``. ``on_grad(step, name, g)`` sees each averaged gradient whole,
    before clipping. Returns each step's loss, and the factor the clip
    scaled each step's gradients by."""
    s = Shape(config)
    opt = config["assumed"]
    world, rank = dist.get_world_size(), dist.get_rank()
    parts = {n: _rank_part(t.numel(), world, rank) for n, t in w.items()}
    own = {n: w[n].view(-1)[lo:hi] for n, (lo, hi) in parts.items()}
    state = optim.init_state(own, opt)
    max_norm = float(opt.get("grad_clip_norm", 0.0))
    losses, scales = [], []
    for step, tokens in enumerate(batches, start=1):
        grads: Dict[str, torch.Tensor] = {}

        def sink(group: Dict[str, torch.Tensor], step=step, grads=grads) -> None:
            for n, g in group.items():
                dist.all_reduce(g)
                g.div_(world)
                if on_grad is not None:
                    on_grad(step, n, g)
                lo, hi = parts[n]
                grads[n] = g.view(-1)[lo:hi].clone()

        loss, _ = loss_and_grads(w, tokens, s, sink)
        total = torch.tensor([loss], dtype=torch.float64, device=tokens.device)
        dist.all_reduce(total)
        scale = 1.0
        if max_norm > 0:
            sq = sum(g.double().pow(2).sum() for g in grads.values())
            dist.all_reduce(sq)
            norm = float(sq.sqrt())
            if norm >= max_norm:
                scale = max_norm / norm
                for g in grads.values():
                    g.mul_(scale)
        optim.update(own, grads, state, step, opt)
        del grads
        for n, t in w.items():
            _gather_parts(t, parts[n][1] - parts[n][0], world)
        losses.append(float(total) / world)
        scales.append(scale)
    return losses, scales


def _rank_part(numel: int, world: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of a flattened leaf that ``rank`` updates: chunks of
    ceil(numel / world), the last ones shorter or empty."""
    chunk = -(-numel // world)
    return min(numel, rank * chunk), min(numel, (rank + 1) * chunk)


def _gather_parts(t: torch.Tensor, own: int, world: int) -> None:
    """Every rank's part of ``t`` (as :func:`_rank_part` splits it) into
    ``t`` on every rank."""
    chunk = -(-t.numel() // world)
    lo, _ = _rank_part(t.numel(), world, dist.get_rank())
    mine = torch.zeros(chunk, dtype=t.dtype, device=t.device)
    mine[:own] = t.view(-1)[lo:lo + own]
    out = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(out, mine)
    t.view(-1).copy_(torch.cat(out)[:t.numel()])
