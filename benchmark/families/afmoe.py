"""The afmoe family: a configuration of AFMoE's equations (Arcee's Trinity)
run through the port's ``models.afmoe`` and trained by
``ops.trainer.Trainer``, on one card.

As in the decoder family, the benchmark draws the weights on the card from
the seed and copies them into the program's model; the reference gets the
same draw. The traffic's ids are Zipf over the vocabulary (rank r with
probability proportional to r^-s, ranks mapped to ids by a permutation drawn
from the seed), drawn here, batch by batch on the device from the seed
and the batch's index, and kept on the host; each step copies the next
batch through ``ops.data.make_global_batch`` and calls
``Trainer.train_step``, which also moves the experts' balancing bias.
Both sides start each MoE layer's bias where the balancing rule evens the
first batch's routing (``reference.afmoe.balanced_biases``, in float32
from the drawn weights), and warm the learning rate up from 0 over the
configuration's ``warmup_steps``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from benchmark import readings, traffic
from benchmark.families.decoder import DTYPES, trainer_config
from benchmark.reference import afmoe as ref_afmoe
from benchmark.reference import exact


def leaves(config: Dict[str, Any]):
    """(name, shape, std or None for a norm scale) of every leaf, in the
    order they are drawn."""
    s = ref_afmoe.Shape(config)
    std = float(config["assumed"]["initializer_range"])
    q, kv, fs = s.h * s.dh, s.kv * s.dh, s.shared * s.fe
    out = [("embed", (s.vocab, s.d), std)]
    for i in range(s.layers):
        p = f"layers.{i}."
        out += [(p + "norm_in", (s.d,), None), (p + "wq", (s.d, q), std),
                (p + "wk", (s.d, kv), std), (p + "wv", (s.d, kv), std),
                (p + "wg", (s.d, q), std), (p + "wo", (q, s.d), std),
                (p + "q_norm", (s.dh,), None), (p + "k_norm", (s.dh,), None),
                (p + "norm_post_attn", (s.d,), None), (p + "norm_pre_mlp", (s.d,), None),
                (p + "norm_post_mlp", (s.d,), None)]
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
    ``device``: norm scales 1, but the two post norms' ``post_norm_gain``
    (``assumed``; 1 where it is not given)."""
    g = traffic.generator(seed, "weights", device)
    gain = float(config["assumed"].get("post_norm_gain", 1.0))
    for name, shape, std in leaves(config):
        if std is None:
            post = name.endswith(("norm_post_attn", "norm_post_mlp"))
            yield name, torch.full(shape, gain if post else 1.0, device=device)
        else:
            yield name, torch.empty(shape, device=device).normal_(0.0, std, generator=g)


def pool(mix: Dict[str, Any], config: Dict[str, Any], seed: int,
         device) -> List[Dict[str, np.ndarray]]:
    """``mix["pool"]`` host batches ``{"tokens": int32 [B, T]}``, ids Zipf
    with exponent ``mix["zipf_exponent"]`` over ``vocab_size``: each id is
    the rank drawn by inverting the ranks' cumulative distribution at a
    uniform draw, through a permutation of the vocabulary drawn from the
    seed. Every seed draws the same sizes."""
    vocab = int(config["vocab_size"])
    b, t = int(mix["global_batch"]), int(mix["seq_len"])
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow(-float(mix["zipf_exponent"])), 0)
    cdf = cdf / cdf[-1]
    perm = torch.randperm(vocab, generator=traffic.generator(seed, "zipf-ids", device),
                          device=device)
    out = []
    for i in range(int(mix["pool"])):
        u = torch.rand(b, t, generator=traffic.generator(seed, f"batch{i}", device),
                       dtype=torch.float64, device=device)
        rank = torch.searchsorted(cdf, u).clamp_max(vocab - 1)
        out.append({"tokens": perm[rank].to(torch.int32).cpu().numpy()})
    return out


def trainer_config_of(config: Dict[str, Any]):
    """The decoder family's ``TrainerConfig`` with the warmup of ``assumed``."""
    return dataclasses.replace(trainer_config(config),
                               warmup_steps=int(config["assumed"].get("warmup_steps", 0)))


def start_biases(w: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 config: Dict[str, Any]) -> Dict[int, torch.Tensor]:
    """Each MoE layer's starting bias (``reference.afmoe.balanced_biases``,
    float32 with TF32 off), from the float32 weights ``w`` and the first
    batch's ``tokens``: the same on the program's side and the reference's."""
    with exact():
        return ref_afmoe.balanced_biases(w, tokens, config)


def model_config(config: Dict[str, Any], precision: Optional[str] = None):
    """The port's ``afmoe.Config`` for a configuration file."""
    from mpi_operator_tpu_torch.models import afmoe

    s, a = ref_afmoe.Shape(config), config["assumed"]
    every = int(config["global_attn_every_n_layers"])
    c = afmoe.Config(
        vocab=s.vocab, d_model=s.d, n_layers=s.layers, n_heads=s.h, n_kv_heads=s.kv,
        head_dim=s.dh, d_ff=s.ff, n_dense_layers=s.dense, n_experts=s.experts,
        top_k=s.top_k, d_expert=s.fe, n_shared_experts=s.shared, route_scale=s.route_scale,
        balance_coeff=s.coeff, window=s.window, global_every=every, rope_theta=s.theta,
        norm_eps=s.eps, compute_dtype=DTYPES[a["compute_dtype"]],
        remat_layers=bool(a["remat_layers"]), matmul_precision=precision or "bf16")
    if [c.is_global(i) for i in range(s.layers)] != [not s.sliding(i) for i in range(s.layers)]:
        raise ValueError("layer_types is not global_attn_every_n_layers' pattern")
    if not (s.mup and s.route_norm):
        raise ValueError("the port's AFMoE scales the embedding (mup_enabled) and normalises "
                         "the routing weights (route_norm)")
    return c


class Session:
    """The program's training step on one card, fed from the Zipf pool.
    ``precision`` (``int8``/``fp8``) switches on the port's quantized
    dense-FFN and shared-expert products: the control, never the
    benchmark's own runs."""

    unit = "tokens"  # what a step trains

    def __init__(self, cell, seed: int, device, mesh=None, precision: Optional[str] = None):
        from mpi_operator_tpu_torch.models import afmoe, llama
        from mpi_operator_tpu_torch.ops.trainer import Trainer

        if mesh is not None:
            raise ValueError("the afmoe family runs on one card")
        self.config, self.seed, self.device = cell.config, seed, device
        model = afmoe.AFMoE(model_config(cell.config, precision), device=device)
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
        losses = ref_afmoe.train(w, batches, cell.config, on_grads, biases)
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
