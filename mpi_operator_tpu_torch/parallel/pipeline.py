"""Pipeline parallelism over the ``pipe`` mesh axis: a GPipe schedule.

Port of ``mpi_operator_tpu/parallel/pipeline.py``. There one program runs
on every device under ``shard_map`` and activations hop stage to stage by
``ppermute``; here every rank of the ``pipe`` axis runs the same loop of
S + M − 1 ticks and the hop is :func:`~.collectives.ring_shift`, whose
backward shifts the gradients back, so a loss over the pipeline's output
trains every stage's parameters.

- :func:`pipeline_spmd`: stage 0 injects microbatch t at tick t, stage s
  works on microbatch t − s, the last stage banks its results, every other
  stage returns zeros. As in JAX, every stage keeps each tick's result and
  the hop in its graph (selected by masks, not branches), so the ranks run
  the same backward, hop for hop.
- :func:`run_pipeline`: the global view. Every rank passes the whole
  stacked parameters (leading dim: layers) and the whole batch; the layers
  split over ``pipe`` in order, the microbatches' batch dim over the
  ``data`` × ``fsdp`` ranks, the stages' outputs are summed over ``pipe``
  (only the last is not zero) and the rows gathered over ``data`` ×
  ``fsdp``, so every rank returns the whole [B, ...] output. Gradients:
  each rank gets those of its own stage's layers from its own rows (the
  rest are zero); their sum over the ``pipe`` and batch ranks is the whole
  gradient (``jax.grad``'s). Without a ``pipe`` axis above 1, the layers
  run in order on the whole batch.

No kernel of its own: the stages are whatever ``stage_fn`` computes.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from mpi_operator_tpu_torch.parallel import collectives as c
from mpi_operator_tpu_torch.runtime.topology import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_PIPE,
    axis_group,
    mesh_sizes,
)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _run_layers(stage_fn: Callable, stacked, x: torch.Tensor) -> torch.Tensor:
    """``stage_fn`` of each layer in order (the JAX ``lax.scan`` body)."""
    for i in range(_leaves(stacked)[0].shape[0]):
        x = stage_fn(_tree_map(lambda a: a[i], stacked), x)
    return x


def pipeline_spmd(stage_fn: Callable, stage_params, microbatches: torch.Tensor, *, group):
    """The GPipe schedule on the ``pipe`` ranks of ``group``.

    ``stage_fn(stage_params, x) -> y`` is this rank's stage; every rank
    passes the same ``microbatches`` [M, ...] and only stage 0 reads them.
    Returns [M, ...]: the last stage's outputs on the last stage, zeros on
    the others."""
    n_stages, stage = c.axis_size(group), c.axis_index(group)
    m = microbatches.shape[0]
    is_first = torch.tensor(stage == 0, device=microbatches.device)
    is_last = stage == n_stages - 1
    inflight = torch.zeros_like(microbatches[0])
    outputs = [torch.zeros_like(microbatches[0]) for _ in range(m)]
    for t in range(m + n_stages - 1):
        # stage 0 injects microbatch t (the last one again once they run
        # out: work no stage banks); the others take the hopped-in value
        x = torch.where(is_first, microbatches[min(t, m - 1)], inflight)
        y = stage_fn(stage_params, x)
        out_idx = t - (n_stages - 1)
        safe = min(max(out_idx, 0), m - 1)
        valid = torch.tensor(is_last and out_idx >= 0, device=y.device)
        outputs[safe] = torch.where(valid, y, outputs[safe])
        # hop to the next stage (last → 0 wraps; stage 0 ignores it)
        inflight = c.ring_shift(y, group)
    out = torch.stack(outputs)
    return torch.where(torch.tensor(is_last, device=out.device), out, torch.zeros_like(out))


def _batch_groups(mesh, batch_axes: Sequence[str]):
    """The process groups of the batch axes above 1, outermost first."""
    return [g for g in (axis_group(mesh, a) for a in batch_axes) if g is not None]


def run_pipeline(stage_fn: Callable, stacked_params, batch: torch.Tensor, mesh, *,
                 n_microbatches: int, axis_name: str = AXIS_PIPE,
                 batch_axes: Sequence[str] = (AXIS_DATA, AXIS_FSDP)) -> torch.Tensor:
    """Global view (see the module docstring): ``stacked_params`` (leading
    dim = layers) and ``batch`` (leading dim = rows) are whole on every
    rank, and so is the [B, ...] output."""
    if mesh is None or mesh_sizes(mesh).get(axis_name, 1) == 1:
        return _run_layers(stage_fn, stacked_params, batch)
    pipe = axis_group(mesh, axis_name)
    n_stages, stage = c.axis_size(pipe), c.axis_index(pipe)
    n_layers = _leaves(stacked_params)[0].shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split over {axis_name}={n_stages}")
    per = n_layers // n_stages
    local = _tree_map(lambda a: a[stage * per:(stage + 1) * per], stacked_params)

    b = batch.shape[0]
    if b % n_microbatches:
        raise ValueError(f"a batch of {b} rows does not split into {n_microbatches} microbatches")
    micro = batch.reshape(n_microbatches, b // n_microbatches, *batch.shape[1:])
    groups = _batch_groups(mesh, batch_axes)
    for g in groups:  # this rank's rows of every microbatch, data-major
        micro = c.scatter_to_group(micro, g, dim=1)
    outs = pipeline_spmd(lambda p, x: _run_layers(stage_fn, p, x), local, micro, group=pipe)
    # only the last stage is not zero: the sum broadcasts its outputs
    outs = c.reduce_from_tp(outs, pipe)
    for g in reversed(groups):
        outs = c.gather_from_group(outs, g, dim=1)
    return outs.reshape(b, *outs.shape[2:])
