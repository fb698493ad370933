"""The optimizer phase (``kernels/optim.py``) on the CPU: no CUDA is needed
to plan launches, to choose the leaves the kernels take, or to run the plain
versions.

- ``plan`` cuts leaves into launches of at most the library's capacity and
  each leaf into chunks, skipping empty leaves, and starts a launch before
  a chunk count would pass 2**31 - 1;
- ``fits`` takes a leaf whose four tensors are f32 (mu f32 or bf16),
  contiguous and of one shape, and nothing else; the kernels' entry points
  refuse any other tensor, and CPU tensors, with a ``ValueError`` before
  loading anything; a CPU step takes the plain versions, which never call
  the kernels;
- ``adamw_plain_`` applies the clip's factor to each gradient as it reads
  it, leaving the gradient as it was, and gives bit for bit the plain
  trainer's update after an in-place ``scale_by_clip_``; it takes a leaf
  the kernels refuse (their entry point stops at it) and gives the bits of
  a contiguous copy;
- under FSDP2 and the ``tensor`` split (CPU gangs of four), every rank's
  local shards fit K-adamw, and one ``adamw_`` call a step takes them all.

The kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.kernels import optim
from mpi_operator_tpu_torch.models import llama
from mpi_operator_tpu_torch.ops import data
from mpi_operator_tpu_torch.ops.trainer import Trainer, TrainerConfig, scale_by_clip_

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

    for fn in ("load", "sum_squares_cuda", "adamw_cuda_"):
        monkeypatch.setattr(optim, fn, refuse)
    trainer, state, batch = _tiny(TrainerConfig(learning_rate=1e-3, grad_clip_norm=0.05))
    _, metrics = trainer.train_step(state, batch)
    assert float(metrics["grad_norm"]) > 0.05


def _refused_by_sum_squares(tensor):
    with pytest.raises(ValueError, match="K-norm"):
        optim.sum_squares_cuda([torch.zeros(3), tensor])


def _refused_by_adamw(leaf):
    with pytest.raises(ValueError, match="K-adamw cannot take leaf w|CUDA tensors"):
        optim.adamw_cuda_({"v": _leaf(), "w": leaf}, None, 1.0, 1e-3, 0.9, 0.95, 0.1, 0.05,
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


def _tiny(config: TrainerConfig):
    model = llama.init(llama.tiny(), torch.Generator().manual_seed(0), "cpu")
    trainer = Trainer(lambda m, b: llama.loss_fn(m, b), config)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)
    return trainer, trainer.init_state(model), data.make_global_batch({"tokens": tokens}, "cpu")


def _clipped_then_adamw_(leaves, norm, max_norm, lr, beta1, beta2, count, weight_decay):
    """The trainer's plain update as it stood before the update took the
    clip's factor itself: ``scale_by_clip_`` scales the gradients in place,
    then AdamW over the clipped gradients."""
    if norm is not None:
        scale_by_clip_([g for _, g, _, _ in leaves.values()], norm, max_norm)
    bc1 = 1.0 - beta1 ** count
    bc2 = 1.0 - beta2 ** count
    for p, g, mu, nu in leaves.values():
        b1 = torch.tensor(beta1, dtype=mu.dtype).item()
        m = (mu * b1).float().add_(g, alpha=1.0 - beta1)
        nu.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
        upd = (m / bc1).div_((nu / bc2).sqrt_().add_(1e-8))
        if weight_decay:
            upd.add_(p, alpha=weight_decay)
        p.add_(upd, alpha=-lr)
        mu.copy_(m)


def _random_leaves(mu_dtype, seed=0, shapes=((6, 4), (17,), (3, 5, 2))):
    """name -> (p, g, mu, nu): random p, g and mu, a non-negative nu."""
    gen = torch.Generator().manual_seed(seed)
    leaves = {}
    for i, shape in enumerate(shapes):
        p, g, mu, nu = (torch.randn(shape, generator=gen) for _ in range(4))
        leaves[f"leaf{i}"] = (p, g, (0.1 * mu).to(mu_dtype), 0.01 * nu.square())
    return leaves


def _copy(leaves):
    return {n: tuple(t.clone() for t in leaf) for n, leaf in leaves.items()}


@pytest.mark.parametrize("norm", [2.5, 0.5, None], ids=["above", "below", "none"])
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["mu_f32", "mu_bf16"])
def test_trainer_around_the_kernels_matches_the_plain_trainer(mu_dtype, norm):
    """The update the trainer calls around the kernels' contract (the clip's
    factor applied as each g is read, g left as it was), in its plain
    version: three steps of ``adamw_plain_`` (max_norm 1, the norm above
    it, below it, or no clip; weight decay 0.1) against the plain trainer's
    ``scale_by_clip_`` in place and then AdamW: p, mu and nu bit for bit,
    and every g as it was."""
    max_norm, lr, beta1, beta2, wd = 1.0, 1e-2, 0.9, 0.95, 0.1
    got = _random_leaves(mu_dtype)
    want = _copy(got)
    for count in (1, 2, 3):
        grads = {n: leaf[1].clone() for n, leaf in got.items()}
        norm_t = None if norm is None else torch.tensor(norm * count, dtype=torch.float32)
        optim.adamw_plain_(got, norm_t, max_norm, lr, beta1, beta2, 1.0 - beta1 ** count,
                           1.0 - beta2 ** count, 1e-8, wd)
        _clipped_then_adamw_(want, norm_t, max_norm, lr, beta1, beta2, count, wd)
        for name, (p, g, mu, nu) in got.items():
            assert torch.equal(g, grads[name]), f"{name}: adamw_plain_ wrote g"
            for what, a, b in (("p", p, want[name][0]), ("mu", mu, want[name][2]),
                               ("nu", nu, want[name][3])):
                assert a.dtype == b.dtype and torch.equal(a, b), f"{what} of {name}, step {count}"
        for name, (_, g, _, _) in want.items():  # the next step's gradients, unscaled
            g.copy_(grads[name])


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["mu_f32", "mu_bf16"])
def test_the_card_path_stops_at_a_leaf_the_kernels_cannot_take(mu_dtype):
    """A leaf of every other column of a buffer (not contiguous): K-adamw's
    entry point refuses it, naming the leaf, before anything is written;
    ``adamw_plain_`` takes it and gives the bits of the same update on a
    contiguous copy."""
    strided = {n: tuple(t[..., ::2] for t in leaf)
               for n, leaf in _random_leaves(mu_dtype, shapes=((6, 8), (4, 3, 10))).items()}
    dense = {n: tuple(t.contiguous() for t in leaf) for n, leaf in strided.items()}
    hyper = (torch.tensor(3.0), 1.0, 1e-2, 0.9, 0.95, 0.1, 0.05, 1e-8, 0.1)
    with pytest.raises(ValueError, match="K-adamw cannot take leaf leaf0"):
        optim.adamw_cuda_(strided, *hyper)
    assert all(torch.equal(a, b) for n, leaf in strided.items()
               for a, b in zip(leaf, dense[n]))
    for leaves in (strided, dense):
        optim.adamw_plain_(leaves, *hyper)
    for name, leaf in strided.items():
        for what, a, b in zip("p g mu nu".split(), leaf, dense[name]):
            assert torch.equal(a, b), f"{what} of {name}"


def _rank(local_rank, args):
    """One rank of a CPU gang: three steps of the plan's sharded trainer.
    Rank 0 prints, for every rank and step, how many leaves each call of
    ``optim.adamw_`` took and how many of them fit K-adamw."""
    import dataclasses

    import torch.distributed as dist

    from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
    from mpi_operator_tpu_torch.runtime import bootstrap

    mesh = gang(local_rank, args["plan"])
    cfg = dataclasses.replace(llama.tiny(), compute_dtype=torch.float32)
    config = TrainerConfig(learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=0.05,
                           adam_mu_bf16=args["mu_bf16"])
    calls = []
    adamw_ = optim.adamw_

    def counted(leaves, *rest):
        calls.append([len(leaves), sum(optim.fits(*leaf) for leaf in leaves.values())])
        adamw_(leaves, *rest)

    optim.adamw_ = counted
    model = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    trainer = Trainer(llama.loss_fn, config, mesh=mesh)
    state = trainer.init_state(model)
    stream = synthetic_tokens(global_batch=4, seq_len=32, vocab=cfg.vocab)
    steps = []
    for _ in range(3):
        before = len(calls)
        state, _ = trainer.train_step(state, make_global_batch(next(stream), "cpu", mesh))
        steps.append(calls[before:])
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, steps)
    if dist.get_rank() == 0:
        print(json.dumps({"steps": gathered, "leaves": len(list(model.parameters()))}))
    bootstrap.shutdown()


@pytest.mark.parametrize("plan,mu_bf16", [("fsdp=4", False), ("fsdp=2,tensor=2", True)])
def test_sharded_local_shards_take_the_card_path(plan, mu_bf16):
    """FSDP2's shards (of dim 0 and of dim 1, both contiguous locally) and
    the ``tensor`` split's: on every rank and every step one ``adamw_`` call
    takes every leaf, and each leaf's local p, g, mu and nu fit K-adamw. (The
    sharded update against the one-device trainer:
    tests/test_torch_sharded_step.py.)"""
    got = run_ranks(__file__, 4, {"plan": plan, "mu_bf16": mu_bf16})
    n = got["leaves"]
    assert got["steps"] == [[[[n, n]]] * 3] * 4


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
