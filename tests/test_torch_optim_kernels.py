"""The optimizer kernels' host side (``kernels/optim.py``), on the CPU: no
CUDA is needed to plan launches or to choose the leaves the kernels take.

- ``plan`` cuts leaves into launches of at most the library's capacity and
  each leaf into chunks, skipping empty leaves, and starts a launch before
  a chunk count would pass 2**31 - 1;
- ``fits`` takes a leaf whose four tensors are f32 (mu f32 or bf16),
  contiguous and of one shape, and nothing else; the kernels refuse any other tensor,
  and CPU tensors, with a ``ValueError`` before loading anything; CPU
  tensors take the plain code, which never calls the kernels;
- in a captured step the two counters add up to the model's parameter
  count, all of it plain on the CPU;
- the trainer's wiring around the kernels (on the card the clip leaves the
  gradients unscaled and hands K-adamw the norm) gives the plain trainer's
  parameters when the kernels are stood in for by their arithmetic in
  PyTorch, and then counts every element as K-adamw's; a leaf the kernels
  cannot take stops the step;
- under FSDP2 and the ``tensor`` split (CPU gangs of four), every rank's
  local shards fit K-adamw, and that path gives the plain sharded trainer's
  losses, norms and parameters.

The kernels themselves are held to the plain code on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpi_operator_tpu_torch.kernels import optim
from mpi_operator_tpu_torch.models import llama
from mpi_operator_tpu_torch.ops import data, trainer as trainer_mod
from mpi_operator_tpu_torch.ops.trainer import Trainer, TrainerConfig
from mpi_operator_tpu_torch.runtime import stepstats

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sharded_step import gang, run_ranks  # noqa: E402


@pytest.mark.parametrize(
    "sizes,capacity,chunk,want",
    [
        ([10], 4, 4, [([0], [3])]),
        ([4, 5, 0, 1], 4, 4, [([0, 1, 3], [1, 3, 4])]),  # the empty leaf takes no room
        ([1] * 5, 2, 4, [([0, 1], [1, 2]), ([2, 3], [1, 2]), ([4], [1])]),
        ([8, 9, 7], 3, 8, [([0, 1, 2], [1, 3, 4])]),
        ([0, 0], 2, 4, []),
        ([], 2, 4, []),
    ],
)
def test_plan_cuts_leaves_into_launches_and_chunks(sizes, capacity, chunk, want):
    assert optim.plan(sizes, capacity, chunk) == want


def test_plan_starts_a_launch_before_the_chunk_count_overflows():
    big = 2 ** 30
    assert optim.plan([big, big, 1], 8, 1) == [([0], [big]), ([1, 2], [big, big + 1])]
    assert optim.plan([big - 1, big], 8, 1) == [([0, 1], [big - 1, 2 ** 31 - 1])]


def test_plan_at_the_librarys_capacity():
    launches = optim.plan([3] * (2 * optim.ADAMW_CAPACITY + 1), optim.ADAMW_CAPACITY)
    assert [len(idx) for idx, _ in launches] == [optim.ADAMW_CAPACITY] * 2 + [1]
    assert launches[1][0][0] == optim.ADAMW_CAPACITY and launches[1][1][-1] == optim.ADAMW_CAPACITY


def _leaf(shape=(6, 4), mu=torch.bfloat16, layout=None):
    def make(dtype=torch.float32):
        t = torch.zeros(shape, dtype=dtype)
        return layout(t) if layout else t

    return make(), make(), make(mu), make()


@pytest.mark.parametrize(
    "case,leaf,want",
    [
        ("contiguous, bf16 mu", _leaf(), True),
        ("contiguous, f32 mu", _leaf(mu=torch.float32), True),
        ("column-major, all four", _leaf(layout=lambda t: t.t().contiguous().t()), False),
        ("a view past the first element", _leaf(layout=lambda t: t.reshape(-1)[1:]), True),
        ("every other column", _leaf(layout=lambda t: t[:, ::2]), False),
        ("f16 mu", _leaf(mu=torch.float16), False),
        ("bf16 parameter", tuple(t.to(torch.bfloat16) if i == 0 else t
                                 for i, t in enumerate(_leaf())), False),
        ("g of another layout", tuple(t.t().contiguous().t() if i == 1 else t
                                      for i, t in enumerate(_leaf())), False),
        ("nu of another shape", tuple(t.reshape(4, 6) if i == 3 else t
                                      for i, t in enumerate(_leaf())), False),
    ],
)
def test_fits_takes_dense_leaves_of_one_layout(case, leaf, want):
    assert optim.fits(*leaf) is want, case


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """A CPU step with the clip and AdamW calls no kernel and loads no
    library."""

    def refuse(*args, **kwargs):
        raise AssertionError("the optimizer kernels ran for CPU tensors")

    for fn in ("load", "sum_squares", "adamw_"):
        monkeypatch.setattr(optim, fn, refuse)
    trainer, state, batch = _tiny(TrainerConfig(learning_rate=1e-3, grad_clip_norm=0.05))
    _, metrics = trainer.train_step(state, batch)
    assert float(metrics["grad_norm"]) > 0.05


def _refused_by_sum_squares(tensor):
    with pytest.raises(ValueError, match="K-norm"):
        optim.sum_squares([torch.zeros(3), tensor])


def _refused_by_adamw(leaf):
    with pytest.raises(ValueError, match="K-adamw cannot take leaf w|CUDA tensors"):
        optim.adamw_({"v": _leaf(), "w": leaf}, None, 1.0, 1e-3, 0.9, 0.95, 0.1, 0.05,
                     1e-8, 0.0)


@pytest.mark.parametrize(
    "case,refused",
    [
        ("K-norm: a bf16 gradient",
         lambda: _refused_by_sum_squares(torch.zeros(3, dtype=torch.bfloat16))),
        ("K-norm: every other element", lambda: _refused_by_sum_squares(torch.zeros(6)[::2])),
        ("K-norm: a CPU tensor", lambda: _refused_by_sum_squares(torch.zeros(3))),
        ("K-adamw: every other column", lambda: _refused_by_adamw(
            _leaf(layout=lambda t: t[:, ::2]))),
        ("K-adamw: a CPU leaf", lambda: _refused_by_adamw(_leaf())),
    ],
)
def test_the_kernels_refuse_what_they_cannot_take(monkeypatch, case, refused):
    def no_build():
        raise AssertionError("loaded before refusing")

    monkeypatch.setattr(optim, "load", no_build)
    refused()


def _tiny(config: TrainerConfig, strided: bool = False):
    model = llama.init(llama.tiny(), torch.Generator().manual_seed(0), "cpu")
    if strided:  # one leaf whose parameter is every other element of a buffer
        w = model.layers[0].wq
        w.data = torch.zeros(w.shape[0], 2 * w.shape[1])[:, ::2].copy_(w.data)
    trainer = Trainer(lambda m, b: llama.loss_fn(m, b), config)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)
    return trainer, trainer.init_state(model), data.make_global_batch({"tokens": tokens}, "cpu")


def _counted_steps(trainer, state, batch, steps):
    stepstats.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(steps):
                state, _ = trainer.train_step(state, batch)
        return state, stepstats.counter_totals()
    finally:
        stepstats.reset_counters()


def test_counters_add_up_to_the_parameter_count():
    trainer, state, batch = _tiny(TrainerConfig(learning_rate=1e-3))
    n = sum(p.numel() for p in state.params.parameters())
    _, totals = _counted_steps(trainer, state, batch, 2)
    assert totals == {"steps": 2, "counters": {"trainer.update.fused": 0.0,
                                               "trainer.update.plain": 2.0 * n}}


def _sum_squares_in_torch(tensors):
    return sum(t.float().pow(2).sum() for t in tensors)


def _adamw_in_torch(leaves, norm, max_norm, lr, beta1, beta2, bc1, bc2, eps, weight_decay):
    """K-adamw's arithmetic (csrc/optim.cu's update), in PyTorch, with its
    refusal of a leaf it cannot take before anything is written."""
    factor = 1.0 if norm is None else torch.where(norm < max_norm, torch.ones_like(norm),
                                                  max_norm / norm)
    for name, leaf in leaves.items():
        if not optim.fits(*leaf):
            raise ValueError(f"K-adamw cannot take leaf {name}")
    for p, g, mu, nu in leaves.values():
        g = g * factor
        b1 = torch.tensor(beta1, dtype=mu.dtype).item()
        m = (mu * b1).float() + (1.0 - beta1) * g
        nu.mul_(beta2).add_((1.0 - beta2) * (g * g))
        upd = (m / bc1) / ((nu / bc2).sqrt() + eps)
        if weight_decay:
            upd = upd + weight_decay * p
        p.add_(-lr * upd)
        mu.copy_(m)


def _kernels_in_torch(monkeypatch):
    """The trainer takes its card path on the CPU, the kernels stood in for
    by their arithmetic in PyTorch."""
    monkeypatch.setattr(trainer_mod, "_on_card", lambda tensors: len(tensors) > 0)
    monkeypatch.setattr(optim, "sum_squares", _sum_squares_in_torch)
    monkeypatch.setattr(optim, "adamw_", _adamw_in_torch)


@pytest.mark.parametrize("mu_bf16", [True, False])
def test_trainer_around_the_kernels_matches_the_plain_trainer(monkeypatch, mu_bf16):
    """Three steps, the clip acting on each (max_norm 0.05), weight decay
    0.1: the plain trainer against one whose kernels are stood in for by
    their arithmetic in PyTorch. A gradient clipped twice, or not at all,
    moves the parameters far past 1e-6."""
    config = TrainerConfig(learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=0.05,
                           adam_mu_bf16=mu_bf16)
    trainer, plain, batch = _tiny(config)
    plain, _ = _counted_steps(trainer, plain, batch, 3)

    _kernels_in_torch(monkeypatch)
    trainer, fused, batch = _tiny(config)
    fused, totals = _counted_steps(trainer, fused, batch, 3)

    n = sum(p.numel() for p in fused.params.parameters())
    assert totals["counters"] == {"trainer.update.fused": 3.0 * n,
                                  "trainer.update.plain": 0.0}
    for (name, a), b in zip(plain.params.named_parameters(), fused.params.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    for key in ("mu", "nu"):
        for name, a in plain.opt_state[key].items():
            np.testing.assert_allclose(fused.opt_state[key][name].float().numpy(),
                                       a.float().numpy(), rtol=1e-2 if key == "mu" else 1e-6,
                                       atol=1e-9, err_msg=f"{key} {name}")


def test_the_card_path_stops_at_a_leaf_the_kernels_cannot_take(monkeypatch):
    """A strided parameter on the card path is refused, naming the leaf,
    before any parameter moves."""
    _kernels_in_torch(monkeypatch)
    trainer, state, batch = _tiny(TrainerConfig(learning_rate=1e-2), strided=True)
    before = [p.detach().clone() for p in state.params.parameters()]
    with pytest.raises(ValueError, match="layers.0.wq"):
        trainer.train_step(state, batch)
    assert all(torch.equal(a, b) for a, b in zip(before, state.params.parameters()))


def _rank(local_rank, args):
    """One rank of a CPU gang: three steps of the plan's sharded trainer
    from the same weights, on the plain path and then on the card path
    with the kernels stood in for by their arithmetic in PyTorch (which
    refuses a leaf ``fits`` does not take). Rank 0 prints both paths'
    losses, norms and parameters, and the leaves K-adamw took on each rank."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
    from mpi_operator_tpu_torch.runtime import bootstrap

    mesh = gang(local_rank, args["plan"])
    cfg = dataclasses.replace(llama.tiny(), compute_dtype=torch.float32)
    config = TrainerConfig(learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=0.05,
                           adam_mu_bf16=args["mu_bf16"])
    taken = []

    def adamw_(leaves, *rest):
        taken.append(len(leaves))
        _adamw_in_torch(leaves, *rest)

    out = {}
    for path in ("plain", "kernels"):
        if path == "kernels":
            trainer_mod._on_card = lambda tensors: len(tensors) > 0
            optim.sum_squares, optim.adamw_ = _sum_squares_in_torch, adamw_
        model = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
        trainer = Trainer(llama.loss_fn, config, mesh=mesh)
        state = trainer.init_state(model)
        stream = synthetic_tokens(global_batch=4, seq_len=32, vocab=cfg.vocab)
        losses, norms = [], []
        for _ in range(3):
            state, m = trainer.train_step(state, make_global_batch(next(stream), "cpu", mesh))
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
        params = {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach().tolist()
                  for n, p in model.named_parameters()}
        out[path] = {"losses": losses, "norms": norms, "params": params}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, taken)
    if dist.get_rank() == 0:
        print(json.dumps({**out, "taken": gathered,
                          "leaves": len(list(model.parameters()))}))
    bootstrap.shutdown()


@pytest.mark.parametrize("plan,mu_bf16", [("fsdp=4", False), ("fsdp=2,tensor=2", True)])
def test_sharded_local_shards_take_the_card_path(plan, mu_bf16):
    """FSDP2's shards (of dim 0 and of dim 1, both contiguous locally) and
    the ``tensor`` split's: on every rank each leaf's
    local p, g, mu and nu fit K-adamw, one call a step takes them all, and
    the card path's losses and clip norms (the local sums of squares
    all-reduced as before) are the plain path's within 1e-6, and each
    parameter within 1e-5 of its norm (as tests/test_torch_sharded_step.py
    holds it: the stand-in's f32 roundings part from the plain code's in a
    few elements, which Adam's division lifts where nu is near eps)."""
    got = run_ranks(__file__, 4, {"plan": plan, "mu_bf16": mu_bf16})
    assert got["taken"] == [[got["leaves"]] * 3] * 4
    plain, kernels = got["plain"], got["kernels"]
    np.testing.assert_allclose(kernels["losses"], plain["losses"], rtol=1e-6)
    np.testing.assert_allclose(kernels["norms"], plain["norms"], rtol=1e-6)
    for name, a in plain["params"].items():
        a = np.asarray(a)
        diff = np.linalg.norm(np.asarray(kernels["params"][name]) - a)
        assert diff <= 1e-5 * np.linalg.norm(a), (name, diff / np.linalg.norm(a))


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
