"""Single-device trainer: one eager train step with optax's optimizers.

Port of ``mpi_operator_tpu/ops/trainer.py``. The update is written by hand
so that it matches the optax chain the JAX trainer builds, term for term:

- ``clip_by_global_norm``: scale by ``max_norm / norm`` only when
  ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
  norm and always scales, so it would not match);
- ``adamw``: bias-corrected moments, ``eps=1e-8`` outside the square root,
  ``eps_root=0``, decoupled decay added before the learning-rate scale,
  optionally a bf16 first moment (updated in f32, stored in bf16);
- ``sgd`` with optional momentum (``trace``);
- the schedules: constant, ``linear_schedule`` warmup, and
  ``warmup_cosine_decay_schedule``; step n uses the schedule at count n.

Parameters, moments and traces are updated in place (JAX returns new
arrays; in place saves a copy of the whole model per step).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    learning_rate: float = 1e-3
    warmup_steps: int = 0
    total_steps: int = 0  # 0 = constant lr after warmup
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip_norm: float = 1.0
    optimizer: str = "adamw"  # or "sgd", "momentum"
    momentum: float = 0.9
    remat: bool = False  # checkpoint the whole loss fn
    adam_mu_bf16: bool = False  # adamw only: first moment stored in bf16


@dataclasses.dataclass
class TrainState:
    step: int
    params: nn.Module
    opt_state: Dict[str, Any]


def learning_rate(config: TrainerConfig, count: int) -> float:
    """The learning rate at optimizer count ``count`` (optax's schedules)."""
    lr = config.learning_rate
    if config.warmup_steps == 0 and config.total_steps == 0:
        return lr
    if config.total_steps:
        warmup = config.warmup_steps
        decay_steps = max(config.total_steps, warmup + 1)
        if count < warmup:
            return lr * min(count, warmup) / warmup  # linear 0 → lr
        span = decay_steps - warmup
        c = min(count - warmup, span)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / span))
    transition = max(config.warmup_steps, 1)
    return lr * min(count, transition) / transition


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: each gradient becomes
    ``g / norm * max_norm`` where ``norm >= max_norm`` and stays as it is
    below. Returns the norm before clipping."""
    norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)
    return norm


class Trainer:
    """Owns the optimizer and runs the train step.

    Args:
      loss_fn: ``(model, batch) -> scalar loss``.
      config: optimizer, schedule and clipping settings.
    """

    def __init__(self, loss_fn: Callable, config: TrainerConfig = TrainerConfig()):
        if config.optimizer not in ("adamw", "sgd", "momentum"):
            raise ValueError(f"unknown optimizer {config.optimizer!r}")
        self.config = config
        if config.remat:
            inner = loss_fn

            def loss_fn(model, batch):
                return checkpoint(inner, model, batch, use_reentrant=False)

        self._loss_fn = loss_fn

    def init_state(self, model: nn.Module) -> TrainState:
        c = self.config
        params = list(model.parameters())
        if c.optimizer == "adamw":
            mu_dtype = torch.bfloat16 if c.adam_mu_bf16 else None
            opt_state = {
                "mu": [torch.zeros_like(p, dtype=mu_dtype) for p in params],
                "nu": [torch.zeros_like(p) for p in params],
            }
        elif c.optimizer == "momentum":
            opt_state = {"trace": [torch.zeros_like(p) for p in params]}
        else:
            opt_state = {}
        return TrainState(step=0, params=model, opt_state=opt_state)

    def train_step(self, state: TrainState, batch):
        """One step. Returns ``(state, metrics)``; metrics hold device
        tensors (``loss``, and ``grad_norm`` when clipping), unsynchronised."""
        c = self.config
        model = state.params
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss = self._loss_fn(model, batch)
        loss.backward()
        grads = [p.grad for p in params]
        metrics = {"loss": loss.detach()}
        with torch.no_grad():
            if c.grad_clip_norm > 0:
                metrics["grad_norm"] = clip_by_global_norm_(grads, c.grad_clip_norm)
            lr = learning_rate(c, state.step)
            if c.optimizer == "adamw":
                self._adamw(params, grads, state.opt_state, state.step + 1, lr)
            else:
                self._sgd(params, grads, state.opt_state, lr)
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    def _adamw(self, params, grads, opt, count: int, lr: float):
        c = self.config
        bc1 = 1.0 - c.beta1 ** count
        bc2 = 1.0 - c.beta2 ** count
        for p, g, mu, nu in zip(params, grads, opt["mu"], opt["nu"]):
            # b1·mu in mu's dtype, b1 rounded to it too (as in optax, where a
            # Python float times a bf16 moment is a bf16 product); the sum
            # with (1 - b1)·g in f32
            b1 = torch.tensor(c.beta1, dtype=mu.dtype).item()
            m = (mu * b1).float().add_(g, alpha=1.0 - c.beta1)
            nu.mul_(c.beta2).addcmul_(g, g, value=1.0 - c.beta2)
            upd = (m / bc1).div_((nu / bc2).sqrt_().add_(1e-8))
            if c.weight_decay:
                upd.add_(p, alpha=c.weight_decay)
            p.add_(upd, alpha=-lr)
            mu.copy_(m)

    def _sgd(self, params, grads, opt, lr: float):
        traces = opt.get("trace")
        for i, (p, g) in enumerate(zip(params, grads)):
            if traces is not None:
                g = traces[i].mul_(self.config.momentum).add_(g)
            p.add_(g, alpha=-lr)
