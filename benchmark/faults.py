"""Faults planted underneath a run, to show that the comparison catches them.

The CPU tests (``tests/test_bench_faults.py``) run a tiny cell with each;
``benchmark.calibrate --fault`` reads each at a cell's own size on the card,
where a number's upper reading may come from it. None of them is reachable
from ``benchmark.run``.

- ``unchanged``: a step that returns its state (weights, optimizer state and
  running statistics) as it found it;
- ``half``: half of every batch left out, the mean taken over the rest: half
  of its rows, or of its one row's positions;
- ``double``: an answer altered where it is produced: the largest leaf's
  update applied twice;
- ``momentum``: an answer altered where it is produced: momentum SGD's
  coefficient taken as 0 (cells trained with momentum);
- ``exchange``: the exchange between the cards left out: FSDP2's
  reduce-scatter of the gradients returns each rank its own part of its
  own gradient (cells on several cards).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

FAULTS = ("unchanged", "half", "double", "momentum", "exchange")
# the collectives FSDP2 reduce-scatters through, by release
_REDUCE_SCATTERS = ("reduce_scatter_single", "reduce_scatter_tensor")


def applies(name: str, cell) -> bool:
    """Whether cell ``cell`` can have fault ``name``."""
    if name == "momentum":
        return cell.config["assumed"]["optimizer"] == "momentum"
    if name == "exchange":
        return cell.chips > 1
    return True


def _largest(model) -> torch.nn.Parameter:
    return max(model.parameters(), key=lambda p: p.numel())


@contextlib.contextmanager
def planted(name: str):
    """Plant fault ``name`` in the program for the ``with`` block."""
    from mpi_operator_tpu_torch.ops import data
    from mpi_operator_tpu_torch.ops.trainer import Trainer

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")
    real_step, real_batch = Trainer.train_step, data.make_global_batch

    def unchanged(self, state, batch):
        kept = {k: v.detach().clone() for k, v in state.params.state_dict().items()}
        opt = {g: {n: t.clone() for n, t in d.items()} for g, d in state.opt_state.items()}
        state, metrics = real_step(self, state, batch)
        with torch.no_grad():
            state.params.load_state_dict(kept)
            for g, d in opt.items():
                for n, t in d.items():
                    state.opt_state[g][n].copy_(t)
        return state, metrics

    def double(self, state, batch):
        p = _largest(state.params)
        before = p.detach().clone()
        state, metrics = real_step(self, state, batch)
        with torch.no_grad():
            p.add_(p - before)
        return state, metrics

    def momentum(self, state, batch):
        kept = self.config
        self.config = dataclasses.replace(kept, momentum=0.0)
        try:
            return real_step(self, state, batch)
        finally:
            self.config = kept

    def local_only(real):
        def reduce_scatter(output, input, op=dist.ReduceOp.SUM, group=None, async_op=False):
            work = real(output, input, op=op, group=group, async_op=async_op)
            if work is not None:
                work.wait()
            n, r = output.numel(), dist.get_rank(group)
            output.view(-1).copy_(input.reshape(-1)[r * n:(r + 1) * n])
            return work

        return reduce_scatter

    def half(host, *args, **kwargs):
        rows = next(iter(host.values())).shape[0]
        if rows > 1:
            return real_batch({k: v[:rows // 2] for k, v in host.items()}, *args, **kwargs)
        return real_batch({k: v[:, :v.shape[1] // 2] for k, v in host.items()}, *args, **kwargs)

    real_collectives = {n: getattr(dist, n) for n in _REDUCE_SCATTERS if hasattr(dist, n)}
    try:
        if name == "half":
            data.make_global_batch = half
        elif name == "exchange":
            for n, fn in real_collectives.items():
                setattr(dist, n, local_only(fn))
        else:
            Trainer.train_step = {"unchanged": unchanged, "double": double,
                                  "momentum": momentum}[name]
        yield
    finally:
        Trainer.train_step, data.make_global_batch = real_step, real_batch
        for n, fn in real_collectives.items():
            setattr(dist, n, fn)
