"""Trainer: one eager train step with optax's optimizers, on one device or
sharded over a mesh.

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
arrays; in place saves a copy of the whole model per step). A stateful
model (a ResNet) keeps its state as module buffers, which its training
forward updates in place: JAX's ``model_state`` is ``TrainState.model_state``
here, and the remat's recompute leaves it as the forward left it. The optimizer
state is keyed by parameter name, so a checkpoint does not depend on the
order of the parameters.

With a mesh (``Trainer(..., mesh=...)``) the model is sharded over
``tensor`` and with FSDP2 (parallel/sharding.py): parameters and moments
are DTensors, each rank holding its shard, and the update runs on the
local shards, which is exact for an elementwise update. The gradient is
the global batch's, as JAX's is. Over ``sequence`` a rank's loss is its
block's share of its rows' mean (models/llama.py); the trainer takes the
gradient of that share times the ``sequence`` size, so that every
reduction is a mean over the ranks that hold a copy:

- FSDP2 averages the sharded gradients over the batch shards (``data`` ×
  ``fsdp``); after the backward the trainer averages them over
  ``sequence``, where the parameters are whole (the rules shard nothing
  there), in one all-reduce of one flat buffer;
- the replicated gradients (the norm scales, whole on every ``tensor``
  rank) and the reported loss are averaged over every rank: the
  ``tensor`` ranks hold equal copies.

The reported loss is then the global batch's mean, as JAX's replicated
loss is. The global norm sums the squares of every shard over the mesh
(each ``fsdp`` and ``tensor`` shard once) and of each replicated tensor
once, so clipping triggers at the same step as on one device.

The norm's sum of squares and AdamW are kernels/optim.py's, which chooses
their device as flash attention does: on a CUDA device two hand-written
kernels, K-norm and K-adamw, and only they; on any other their plain
versions. For AdamW the clip only takes the norm: the update applies the
clip's factor as it reads each gradient, which stays unscaled, and updates
p, mu and nu in one pass, one call over every leaf. SGD and momentum take
the clip in place (``clip_by_global_norm_``), then the plain update below.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Partial
from torch.utils.checkpoint import checkpoint

from mpi_operator_tpu_torch.kernels import optim
from mpi_operator_tpu_torch.runtime.stepstats import (
    count_step,
    device_mark,
    load_device_marks,
    span,
)


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

    @property
    def model_state(self) -> Dict[str, torch.Tensor]:
        """The model's buffers (a ResNet's batch-norm running statistics; {}
        for the Llama), by reference: the JAX ``TrainState.model_state``.
        The checkpoint's state dict holds them with the parameters."""
        return dict(self.params.named_buffers())


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


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (the tensor itself otherwise); in
    place ops on it update the DTensor."""
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32. A DTensor's
    squares are summed over its shards on every rank of its mesh, over the
    mesh dimensions that shard it (``fsdp``, ``tensor``) and not those that
    replicate it (one reduction for all of them; they must share one mesh).
    A plain tensor is whole on every rank and counts once."""
    plain = [t for t in tensors if not isinstance(t, DTensor)]
    sharded = [t for t in tensors if isinstance(t, DTensor)]
    total = optim.sum_squares(plain)
    if sharded:
        like = sharded[0]
        if any(t.device_mesh != like.device_mesh for t in sharded):
            raise ValueError("global_norm takes DTensors of one mesh")
        local = optim.sum_squares([t.to_local() for t in sharded])
        placements = [Partial() if p.is_shard() else p for p in like.placements]
        total = total + DTensor.from_local(local, like.device_mesh, placements).full_tensor()
    return torch.sqrt(total)


def _pmean_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In place: the mean over ``group``'s ranks (every rank by default; a
    sum, then a division: gloo has no AVG)."""
    dist.all_reduce(t, group=group)
    return t.div_(dist.get_world_size(group))


def _pmean_flat_(tensors, group) -> None:
    """:func:`_pmean_` of each tensor, in one all-reduce of one flat
    buffer."""
    flat = _pmean_(torch.cat([t.reshape(-1) for t in tensors]), group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _buffers_kept_on_recompute(fn: Callable) -> Callable:
    """``fn(model, batch)`` for ``checkpoint``: the backward runs it a second
    time to recompute the activations, and that run must not update the
    model's buffers (batch norm's running statistics) again, as JAX's
    functional remat never does. The buffers are copied before the
    recompute and put back after it (also when the recompute stops early)."""
    ran = []

    def run(model, batch):
        if not ran:
            ran.append(True)
            return fn(model, batch)
        kept = [b.clone() for b in model.buffers()]
        try:
            return fn(model, batch)
        finally:
            with torch.no_grad():
                for b, k in zip(model.buffers(), kept):
                    b.copy_(k)

    return run


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: each gradient becomes
    ``g / norm * max_norm`` where ``norm >= max_norm`` and stays as it is
    below. Returns the norm before clipping."""
    norm = global_norm(grads)
    scale_by_clip_(grads, norm, max_norm)
    return norm


def scale_by_clip_(grads, norm: torch.Tensor, max_norm: float) -> None:
    """The clip's scale, in place, given ``norm``, the norm before clipping:
    each gradient times ``max_norm / norm`` where ``norm >= max_norm``."""
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        _local(g).mul_(factor)


class Trainer:
    """Owns the optimizer and runs the train step.

    Args:
      loss_fn: ``(model, batch) -> scalar loss``.
      config: optimizer, schedule and clipping settings.
      mesh: the job's ``DeviceMesh`` (runtime/topology.py): ``init_state``
        shards the model over it. None: one device, no process group.
    """

    def __init__(self, loss_fn: Callable, config: TrainerConfig = TrainerConfig(), mesh=None):
        if config.optimizer not in ("adamw", "sgd", "momentum"):
            raise ValueError(f"unknown optimizer {config.optimizer!r}")
        self.config = config
        self.mesh = mesh
        self._replicated = []
        self._seq_group = None  # the class docstring says what it reduces
        self._loss_scale = 1  # the sequence size
        self._mark_device = None  # a CUDA device takes device marks (init_state)
        if config.remat:
            inner = loss_fn

            def loss_fn(model, batch):
                return checkpoint(_buffers_kept_on_recompute(inner), model, batch,
                                  use_reentrant=False)

        self._loss_fn = loss_fn

    def init_state(self, model: nn.Module) -> TrainState:
        """The state at step 0; with a mesh, shards ``model`` first (in
        place), so the moments are DTensors laid out as their parameters."""
        c = self.config
        if self.mesh is not None:
            from mpi_operator_tpu_torch.parallel.sharding import shard_model
            from mpi_operator_tpu_torch.runtime.topology import AXIS_SEQ, axis_group

            self._replicated = shard_model(model, self.mesh)
            self._seq_group = axis_group(self.mesh, AXIS_SEQ)
            if self._seq_group is not None:
                self._loss_scale = dist.get_world_size(self._seq_group)
        params = dict(model.named_parameters())
        if params:
            device = _local(next(iter(params.values()))).device
            self._mark_device = device if load_device_marks(device) else None
            if device.type == "cuda" and (c.optimizer == "adamw" or c.grad_clip_norm > 0):
                optim.load()  # set-up's build, so that no step builds it

        def zeros(dtype=None):
            return {n: torch.zeros_like(p, dtype=dtype) for n, p in params.items()}

        if c.optimizer == "adamw":
            opt_state = {"mu": zeros(torch.bfloat16 if c.adam_mu_bf16 else None),
                         "nu": zeros()}
        elif c.optimizer == "momentum":
            opt_state = {"trace": zeros()}
        else:
            opt_state = {}
        return TrainState(step=0, params=model, opt_state=opt_state)

    def train_step(self, state: TrainState, batch):
        """One step. Returns ``(state, metrics)``; metrics hold device
        tensors (``loss``, and ``grad_norm`` when clipping), unsynchronised.

        The step is the span ``trainer.step``, holding ``trainer.forward``,
        ``trainer.backward`` and ``trainer.optimizer`` (the all-reduces, then
        ``trainer.clip``, ``trainer.update`` and, for a model that defines
        ``after_update()`` (AFMoE's expert bias), ``trainer.balance``, which
        calls it after the update). During a capture on a CUDA
        device it also launches four device marks in stream order: ``fwd``
        before the forward, ``bwd`` before the backward, ``opt`` after the
        backward and ``end`` after the update (runtime/stepstats.py)."""
        c = self.config
        model = state.params
        params = dict(model.named_parameters())
        with span("trainer.step"):
            for p in params.values():
                p.grad = None
            device_mark(self._mark_device, "fwd")
            with span("trainer.forward"):
                loss = self._loss_fn(model, batch) * self._loss_scale
            device_mark(self._mark_device, "bwd")
            with span("trainer.backward"):
                loss.backward()
            device_mark(self._mark_device, "opt")
            metrics = {"loss": loss.detach()}
            with span("trainer.optimizer"), torch.no_grad():
                if self.mesh is not None:
                    metrics["loss"] = _pmean_(metrics["loss"].clone())
                    if self._seq_group is not None:
                        replicated = set(self._replicated)
                        _pmean_flat_([_local(p.grad) for p in params.values()
                                      if p not in replicated], self._seq_group)
                    for p in self._replicated:
                        _pmean_(p.grad)
                grads = {n: p.grad for n, p in params.items()}
                adamw = c.optimizer == "adamw"
                norm = None
                if c.grad_clip_norm > 0:
                    with span("trainer.clip"):
                        # AdamW's update applies the clip's factor as it
                        # reads each gradient
                        grad_list = list(grads.values())
                        norm = (global_norm(grad_list) if adamw
                                else clip_by_global_norm_(grad_list, c.grad_clip_norm))
                        metrics["grad_norm"] = norm
                lr = learning_rate(c, state.step)
                with span("trainer.update"):
                    if adamw:
                        count = state.step + 1
                        mu, nu = state.opt_state["mu"], state.opt_state["nu"]
                        leaves = {n: tuple(_local(t) for t in (p, grads[n], mu[n], nu[n]))
                                  for n, p in params.items()}
                        optim.adamw_(leaves, norm, c.grad_clip_norm, lr, c.beta1, c.beta2,
                                     1 - c.beta1 ** count, 1 - c.beta2 ** count, 1e-8,
                                     c.weight_decay)
                    else:
                        self._sgd(params, grads, state.opt_state, lr)
                for p in params.values():
                    p.grad = None
                after_update = getattr(model, "after_update", None)
                if after_update is not None:
                    with span("trainer.balance"):
                        after_update()
            device_mark(self._mark_device, "end")
        count_step()
        state.step += 1
        return state, metrics

    def multi_step(self, state: TrainState, batch, n: int):
        """``n`` steps on one batch; returns ``(state, last metrics)`` (the
        JAX ``multi_step``, there one ``lax.scan`` dispatch: here a loop of
        eager steps)."""
        for _ in range(n):
            state, metrics = self.train_step(state, batch)
        return state, metrics

    def _sgd(self, params, grads, opt, lr: float):
        traces = opt.get("trace")
        for name, p in params.items():
            p, g = _local(p), _local(grads[name])
            if traces is not None:
                g = _local(traces[name]).mul_(self.config.momentum).add_(g)
            p.add_(g, alpha=-lr)
