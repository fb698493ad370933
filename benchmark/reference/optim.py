"""The stated optimizers, in float32: optax's ``clip_by_global_norm``,
``adamw`` (optionally with its first moment stored in bf16) and ``sgd`` with
momentum, as a configuration's ``assumed`` block names them."""

from __future__ import annotations

from typing import Any, Dict

import torch

Tensors = Dict[str, torch.Tensor]


def clip_by_global_norm(grads: Tensors, max_norm: float) -> float:
    """Scale every gradient by ``max_norm / norm`` where the global norm is at
    least ``max_norm`` (in place); returns the norm."""
    norm = float(torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values())))
    if norm >= max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm)
    return norm


def init_state(params: Tensors, opt: Dict[str, Any]) -> Dict[str, Tensors]:
    if opt["optimizer"] == "adamw":
        mu_dtype = torch.bfloat16 if opt.get("adam_mu_bf16") else torch.float32
        return {"mu": {n: torch.zeros_like(p, dtype=mu_dtype) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}
    if opt["optimizer"] == "momentum":
        return {"trace": {n: torch.zeros_like(p) for n, p in params.items()}}
    raise ValueError(f"unknown optimizer {opt['optimizer']!r}")


def update(params: Tensors, grads: Tensors, state: Dict[str, Tensors], count: int,
           opt: Dict[str, Any]) -> None:
    """One update at optimizer count ``count`` (1 for the first), in place.
    A bf16 first moment is scaled by b1 in bf16 (b1 itself rounded to bf16,
    as a Python float times a bf16 array is in optax), summed with
    (1 - b1) g in float32, used at that precision, and stored in bf16."""
    lr = float(opt["learning_rate"])
    if opt["optimizer"] == "momentum":
        for n, p in params.items():
            t = state["trace"][n].mul_(float(opt["momentum"])).add_(grads[n])
            p.add_(t, alpha=-lr)
        return
    b1, b2 = float(opt["beta1"]), float(opt["beta2"])
    wd = float(opt.get("weight_decay", 0.0))
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    for n, p in params.items():
        g, mu, nu = grads[n], state["mu"][n], state["nu"][n]
        if mu.dtype == torch.bfloat16:
            b1_low = torch.tensor(b1, dtype=torch.bfloat16).item()
            m = (mu.float() * b1_low).bfloat16().float() + (1.0 - b1) * g
        else:
            m = b1 * mu + (1.0 - b1) * g
        nu.mul_(b2).add_((1.0 - b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(nu / bc2) + 1e-8)
        if wd:
            upd = upd + wd * p
        p.sub_(lr * upd)
        mu.copy_(m)
