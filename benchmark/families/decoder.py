"""The decoder family: a configuration of Mistral's (Llama's) equations run
through the port's ``models.llama`` and trained by ``ops.trainer.Trainer``.

The benchmark draws the weights on the card from the seed and copies them
into the program's model (over several cards, every rank draws them whole
and the program shards them); the reference gets the same draw. Each step feeds
the next batch of the traffic's pool through ``ops.data.make_global_batch``
(a host-to-device copy) and calls ``Trainer.train_step``: set-up's first
steps, the window and the traced stretch all go through that one call.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from benchmark import readings, traffic
from benchmark.reference import decoder as ref_decoder
from benchmark.reference import exact

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaves(config: Dict[str, Any]):
    """(name, shape, std or None for a unit norm scale) of every leaf, in the
    order they are drawn."""
    s = ref_decoder.Shape(config)
    std = float(config["initializer_range"])
    out = [("embed", (s.vocab, s.d), std)]
    for i in range(s.layers):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (s.d,), None), (p + "wq", (s.d, s.h * s.dh), std),
                (p + "wk", (s.d, s.kv * s.dh), std), (p + "wv", (s.d, s.kv * s.dh), std),
                (p + "wo", (s.h * s.dh, s.d), std), (p + "mlp_norm", (s.d,), None),
                (p + "w_gate", (s.d, s.ff), std), (p + "w_up", (s.d, s.ff), std),
                (p + "w_down", (s.ff, s.d), std)]
    out += [("final_norm", (s.d,), None), ("lm_head", (s.d, s.vocab), std)]
    return out


def draw(config: Dict[str, Any], seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """The float32 weights, one leaf at a time, from one generator on ``device``."""
    g = traffic.generator(seed, "weights", device)
    for name, shape, std in leaves(config):
        if std is None:
            yield name, torch.ones(shape, device=device)
        else:
            yield name, torch.empty(shape, device=device).normal_(0.0, std, generator=g)


def model_config(config: Dict[str, Any], precision: Optional[str] = None):
    """The port's ``llama.Config`` for a configuration file."""
    from mpi_operator_tpu_torch.models import llama

    s, a = ref_decoder.Shape(config), config["assumed"]
    return llama.Config(vocab=s.vocab, d_model=s.d, n_layers=s.layers, n_heads=s.h,
                        n_kv_heads=s.kv, head_dim=s.dh, d_ff=s.ff, rope_theta=s.theta,
                        norm_eps=s.eps, compute_dtype=DTYPES[a["compute_dtype"]],
                        remat_layers=bool(a["remat_layers"]),
                        matmul_precision=precision or "bf16")


def trainer_config(config: Dict[str, Any]):
    from mpi_operator_tpu_torch.ops.trainer import TrainerConfig

    a = config["assumed"]
    return TrainerConfig(learning_rate=float(a["learning_rate"]), optimizer=a["optimizer"],
                         beta1=float(a["beta1"]), beta2=float(a["beta2"]),
                         weight_decay=float(a["weight_decay"]),
                         grad_clip_norm=float(a["grad_clip_norm"]),
                         adam_mu_bf16=bool(a["adam_mu_bf16"]))


def _part(t: torch.Tensor):
    """(this rank's part of ``t``, the part's (offset, shape) in the whole
    leaf): a DTensor's local shard, or the whole of a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t, ((0,) * t.dim(), tuple(t.shape))
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local = t.to_local()
    shape, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    if tuple(shape) != tuple(local.shape):
        raise ValueError(f"a shard of {tuple(local.shape)} where its layout says {shape}")
    return local, (tuple(offset), tuple(shape))


def _within(t: torch.Tensor, layout) -> torch.Tensor:
    offset, shape = layout
    return t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


class Session:
    """The program's training step, fed from the traffic's pool: on one card,
    or this rank's part of it over ``mesh`` (the port's ``Trainer`` shards
    the model with FSDP2, and ``make_global_batch`` gives the rank its rows).
    ``precision`` (``int8``/``fp8``) switches on the port's quantized FFN
    products: the control, never the benchmark's own runs."""

    unit = "tokens"  # what a step trains

    def __init__(self, cell, seed: int, device, mesh=None, precision: Optional[str] = None):
        from mpi_operator_tpu_torch.models import llama
        from mpi_operator_tpu_torch.ops.trainer import Trainer

        self.config, self.seed, self.device, self.mesh = cell.config, seed, device, mesh
        model = llama.Llama(model_config(cell.config, precision), device=device)
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, t in draw(cell.config, seed, device):
                params[name].copy_(t)
        loss = functools.partial(llama.loss_fn, ce_chunk=int(cell.config["assumed"]["ce_chunk"]))
        self.trainer = Trainer(loss, trainer_config(cell.config), mesh=mesh)
        self.state = self.trainer.init_state(model)
        self.pool = traffic.pool(cell.traffic, cell.config, seed, device)
        self.units_per_step = int(cell.traffic["global_batch"]) * int(cell.traffic["seq_len"])
        self.metrics: Dict[str, torch.Tensor] = {}
        self.fed = 0
        self.input_wait_s = []  # the copy is synchronous: no wait is measured apart

    def step(self) -> None:
        from mpi_operator_tpu_torch.ops import data

        batch = data.make_global_batch(self.pool[self.fed % len(self.pool)], self.device,
                                       self.mesh)
        self.fed += 1
        self.state, self.metrics = self.trainer.train_step(self.state, batch)

    def first_steps(self, n: int) -> dict:
        """Steps 1..n, and the program's readings of them. In a gang, each
        rank reads the part of every leaf it holds, under ``<leaf>@<rank>``,
        and every rank gets all ranks' readings and ``layouts``: for each
        leaf, the (offset, shape) of each rank's part."""
        losses, grad = [], {}
        for k in range(1, n + 1):
            self.step()
            losses.append(float(self.metrics["loss"]))
            if k == 1:
                grad = self._first_grad()
        params = dict(self.state.params.named_parameters())
        if self.mesh is None:
            change = readings.change_norms(params, draw(self.config, self.seed, self.device))
            return {"losses": losses, "grad": grad, "change": change}
        rank = dist.get_rank()
        change, layouts = {}, {}
        for name, t0 in draw(self.config, self.seed, self.device):
            local, layouts[name] = _part(params[name].detach())
            change[f"{name}@{rank}"] = readings.norm(local.float() - _within(t0, layouts[name]))
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, (grad, change, layouts))
        out = {"losses": losses, "grad": {}, "change": {}, "layouts": {}}
        for r, (g, c, lay) in enumerate(ranks):
            out["grad"].update(g)
            out["change"].update(c)
            for name, layout in lay.items():
                out["layouts"].setdefault(name, {})[r] = layout
        return out

    def _first_grad(self) -> Dict[str, float]:
        if self.mesh is None:
            return readings.first_grad_norms(self.state.opt_state, self.config["assumed"])
        b2, rank = float(self.config["assumed"]["beta2"]), dist.get_rank()
        return {f"{n}@{rank}": float((_part(nu)[0].double().sum() / (1.0 - b2)).sqrt())
                for n, nu in self.state.opt_state["nu"].items()}

    def close(self) -> None:
        self.state = self.trainer = self.metrics = None


def reference(cell, seed: int, device, steps: int, layouts=None) -> dict:
    """The reference's readings of the first ``steps`` steps. With
    ``layouts`` (a gang's program: for each leaf, each rank's part), the
    reference trains over the gang's ranks too, each taking its share of
    the rows and holding the whole model, and reads each rank's part of
    every leaf as the program names it."""
    w = dict(draw(cell.config, seed, device))
    batches = [torch.from_numpy(b["tokens"]).long().to(device)
               for b in traffic.pool(cell.traffic, cell.config, seed, device)[:steps]]
    grad = {}
    if layouts is None:
        def on_grads(step, grads):
            if step == 1:
                grad.update({n: readings.norm(g) for n, g in grads.items()})

        with exact():
            losses = ref_decoder.train(w, batches, cell.config, on_grads)
        change = readings.change_norms(w, draw(cell.config, seed, device))
        return {"losses": losses, "grad": grad, "change": change}

    world, rank = dist.get_world_size(), dist.get_rank()
    rows = batches[0].shape[0] // world
    mine = [b[rank * rows:(rank + 1) * rows] for b in batches]

    def on_grad(step, name, g):
        if step == 1:
            grad.update({f"{name}@{r}": readings.norm(_within(g, lay))
                         for r, lay in layouts[name].items()})

    with exact():
        losses, scales = ref_decoder.train_data_parallel(w, mine, cell.config, on_grad)
    change = {}
    for name, t0 in draw(cell.config, seed, device):
        moved = w.pop(name) - t0
        change.update({f"{name}@{r}": readings.norm(_within(moved, lay))
                       for r, lay in layouts[name].items()})
    return {"losses": losses, "grad": {k: v * scales[0] for k, v in grad.items()},
            "change": change}


def control(cell, seed: int, device, steps: int, mesh=None) -> dict:
    """The control's readings: the program with its fp8 FFN products (the
    precision below the configuration's bf16 that the port offers)."""
    session = Session(cell, seed, device, mesh=mesh, precision="fp8")
    try:
        return session.first_steps(steps)
    finally:
        session.close()
