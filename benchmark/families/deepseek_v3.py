"""The deepseek_v3 family: a configuration of DeepSeek-V3's equations (here
Kakao's Kanana-2: multi-head latent attention over a 128-expert MoE) run
through the port's ``models.deepseek_v3`` and trained by
``ops.trainer.Trainer``, on one card.

It drives the model as ``families/afmoe.py`` drives Trinity: the weights
drawn on the card from the seed and copied into the program's model (the
reference gets the same draw); the Zipf pool of ``families/afmoe.pool``,
drawn on the device and kept on the host, each step copying the next batch
through ``ops.data.make_global_batch`` into ``Trainer.train_step``, which
also moves the experts' balancing bias; both sides start each MoE layer's
bias where the balancing rule evens the first batch's routing
(``reference.deepseek_v3.balanced_biases``, in float32 from the drawn
weights) and warm the learning rate up from 0 over ``warmup_steps``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from benchmark import readings, traffic
from benchmark.families.afmoe import pool, trainer_config_of
from benchmark.families.decoder import DTYPES
from benchmark.reference import deepseek_v3 as ref_dsv3
from benchmark.reference import exact


def leaves(config: Dict[str, Any]):
    """(name, shape, std or None for a norm scale) of every leaf, in the
    order they are drawn."""
    s = ref_dsv3.Shape(config)
    std = float(config["assumed"]["initializer_range"])
    fs = s.shared * s.fe
    out = [("embed", (s.vocab, s.d), float(config["assumed"].get("embed_init_std", std)))]
    for i in range(s.layers):
        p = f"layers.{i}."
        out += [(p + "norm_in", (s.d,), None), (p + "wq", (s.d, s.h * s.qk), std),
                (p + "w_kv_a", (s.d, s.rank + s.rope), std), (p + "kv_norm", (s.rank,), None),
                (p + "w_kv_b", (s.rank, s.h * (s.nope + s.dv)), std),
                (p + "wo", (s.h * s.dv, s.d), std), (p + "norm_post", (s.d,), None)]
        if i < s.dense:
            out += [(p + "w_gate", (s.d, s.ff), std), (p + "w_up", (s.d, s.ff), std),
                    (p + "w_down", (s.ff, s.d), std)]
        else:
            m = p + "moe."
            out += [(m + "router", (s.d, s.experts), std),
                    (m + "w_gate", (s.experts, s.d, s.fe), std),
                    (m + "w_up", (s.experts, s.d, s.fe), std),
                    (m + "w_down", (s.experts, s.fe, s.d), std),
                    (m + "shared_gate", (s.d, fs), std), (m + "shared_up", (s.d, fs), std),
                    (m + "shared_down", (fs, s.d), std)]
    out += [("final_norm", (s.d,), None), ("lm_head", (s.d, s.vocab), std)]
    return out


def draw(config: Dict[str, Any], seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """The float32 weights, one leaf at a time, from one generator on
    ``device``: the embedding normal(0, ``embed_init_std``) where ``assumed``
    gives one, every other matrix normal(0, ``initializer_range``), norm
    scales 1."""
    g = traffic.generator(seed, "weights", device)
    for name, shape, std in leaves(config):
        if std is None:
            yield name, torch.ones(shape, device=device)
        else:
            yield name, torch.empty(shape, device=device).normal_(0.0, std, generator=g)


def start_biases(w: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 config: Dict[str, Any]) -> Dict[int, torch.Tensor]:
    """Each MoE layer's starting bias (``reference.deepseek_v3.balanced_biases``,
    float32 with TF32 off), from the float32 weights ``w`` and the first
    batch's ``tokens``: the same on the program's side and the reference's."""
    with exact():
        return ref_dsv3.balanced_biases(w, tokens, config)


def model_config(config: Dict[str, Any], precision: Optional[str] = None):
    """The port's ``deepseek_v3.Config`` for a configuration file."""
    from mpi_operator_tpu_torch.models import deepseek_v3

    s, a = ref_dsv3.Shape(config), config["assumed"]
    if not (s.interleave and s.route_norm):
        raise ValueError("the port's DeepSeek-V3 rotates adjacent pairs (rope_interleave) and "
                         "normalises the routing weights (norm_topk_prob)")
    return deepseek_v3.Config(
        vocab=s.vocab, d_model=s.d, n_layers=s.layers, n_heads=s.h, qk_nope_dim=s.nope,
        qk_rope_dim=s.rope, v_dim=s.dv, kv_rank=s.rank, d_ff=s.ff, n_dense_layers=s.dense,
        n_experts=s.experts, top_k=s.top_k, d_expert=s.fe, n_shared_experts=s.shared,
        route_scale=s.route_scale, balance_coeff=s.coeff, rope_theta=s.theta, norm_eps=s.eps,
        compute_dtype=DTYPES[a["compute_dtype"]], remat_layers=bool(a["remat_layers"]),
        matmul_precision=precision or "bf16")


class Session:
    """The program's training step on one card, fed from the Zipf pool.
    ``precision`` (``int8``/``fp8``) switches on the port's quantized
    dense-FFN and shared-expert products: the control, never the
    benchmark's own runs."""

    unit = "tokens"  # what a step trains

    def __init__(self, cell, seed: int, device, mesh=None, precision: Optional[str] = None):
        from mpi_operator_tpu_torch.models import deepseek_v3, llama
        from mpi_operator_tpu_torch.ops.trainer import Trainer

        if mesh is not None:
            raise ValueError("the deepseek_v3 family runs on one card")
        self.config, self.seed, self.device = cell.config, seed, device
        model = deepseek_v3.DeepseekV3(model_config(cell.config, precision), device=device)
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, t in draw(cell.config, seed, device):
                params[name].copy_(t)
        self.pool = pool(cell.traffic, cell.config, seed, device)
        first = torch.from_numpy(self.pool[0]["tokens"]).long().to(device)
        biases = start_biases({n: p.detach() for n, p in params.items()}, first, cell.config)
        with torch.no_grad():
            for i, b in biases.items():
                model.layers[i].moe.expert_bias.copy_(b)
        del first, biases
        loss = functools.partial(llama.loss_fn, ce_chunk=int(cell.config["assumed"]["ce_chunk"]))
        self.trainer = Trainer(loss, trainer_config_of(cell.config))
        self.state = self.trainer.init_state(model)
        self.units_per_step = int(cell.traffic["global_batch"]) * int(cell.traffic["seq_len"])
        self.metrics: Dict[str, torch.Tensor] = {}
        self.fed = 0
        self.input_wait_s: List[float] = []  # the copy is synchronous: no wait apart

    def step(self) -> None:
        from mpi_operator_tpu_torch.ops import data

        batch = data.make_global_batch(self.pool[self.fed % len(self.pool)], self.device)
        self.fed += 1
        self.state, self.metrics = self.trainer.train_step(self.state, batch)

    def first_steps(self, n: int) -> dict:
        """Steps 1..n, and the program's readings of them."""
        losses, grad = [], {}
        for k in range(1, n + 1):
            self.step()
            losses.append(float(self.metrics["loss"]))
            if k == 1:
                grad = readings.first_grad_norms(self.state.opt_state, self.config["assumed"])
        params = dict(self.state.params.named_parameters())
        change = readings.change_norms(params, draw(self.config, self.seed, self.device))
        return {"losses": losses, "grad": grad, "change": change}

    def close(self) -> None:
        self.state = self.trainer = self.metrics = None


def reference(cell, seed: int, device, steps: int) -> dict:
    """The reference's readings of the first ``steps`` steps."""
    w = dict(draw(cell.config, seed, device))
    batches = [torch.from_numpy(b["tokens"]).long().to(device)
               for b in pool(cell.traffic, cell.config, seed, device)[:steps]]
    grad = {}

    def on_grads(step, grads):
        if step == 1:
            grad.update({n: readings.norm(g) for n, g in grads.items()})

    biases = start_biases(w, batches[0], cell.config)
    with exact():
        losses = ref_dsv3.train(w, batches, cell.config, on_grads, biases)
    change = readings.change_norms(w, draw(cell.config, seed, device))
    return {"losses": losses, "grad": grad, "change": change}


def control(cell, seed: int, device, steps: int, mesh=None) -> dict:
    """The control's readings: the program with its fp8 dense-FFN and
    shared-expert products (the precision below the configuration's bf16
    that the port offers)."""
    session = Session(cell, seed, device, mesh=mesh, precision="fp8")
    try:
        return session.first_steps(steps)
    finally:
        session.close()
