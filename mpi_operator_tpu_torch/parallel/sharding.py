"""Logical-axis sharding rules, and the sharding of a model: tensor
parallelism on DTensors, then FSDP2.

Port of ``mpi_operator_tpu/parallel/sharding.py``. ``DEFAULT_RULES``,
:func:`logical_spec` and :func:`mesh_filtered_spec` are copies with the
same semantics (a mesh axis is used at most once; axes the mesh lacks are
dropped); a spec is a plain tuple here, one entry per array dimension
(None, a mesh axis name, or a tuple of them), trailing Nones dropped as
``PartitionSpec`` drops them.

:func:`shard_model` turns the rules into a layout: each parameter is
split over ``tensor`` on the dimension whose logical axis the rules send
there (a DTensor with ``Shard`` on that dimension), then FSDP2 shards it on
the dimension the rules send to ``fsdp``, so the parameter layout is the JAX
package's on both axes. The JAX package's ``with_logical_constraint`` has no
counterpart: every activation is rank-local (this rank's batch and sequence
block, its heads and vocab columns under ``tensor``), and the model calls
the collectives itself (models/llama.py); there is no partitioner to steer.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

from mpi_operator_tpu_torch.runtime.topology import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_SEQ,
    AXIS_TENSOR,
    batch_mesh,
    mesh_sizes,
)

Rule = Union[str, Tuple[str, ...], None]
Rules = Dict[str, Rule]
Spec = Tuple[Rule, ...]

DEFAULT_RULES: Rules = {
    "batch": (AXIS_DATA, AXIS_FSDP),
    "seq": AXIS_SEQ,
    "embed": AXIS_FSDP,
    "mlp": AXIS_TENSOR,
    "heads": AXIS_TENSOR,
    "kv_heads": AXIS_TENSOR,
    "qkv": None,
    "head_dim": None,
    "vocab": AXIS_TENSOR,
    "expert": AXIS_EXPERT,
    "conv_kernel": None,
    "conv_in": None,
    "conv_out": AXIS_FSDP,
    "stats": None,
}

def logical_spec(logical_axes: Sequence[Optional[str]], rules: Optional[Rules] = None) -> Spec:
    """(logical axis per array dim) → spec via the rule table. When two
    logical axes map to the same mesh axis the later one degrades to
    replicated (flax's logical-axis semantics)."""
    rules = DEFAULT_RULES if rules is None else rules
    used: set = set()
    parts = []
    for ax in logical_axes:
        rule = rules.get(ax) if ax is not None else None
        if rule is None:
            parts.append(None)
            continue
        mesh_axes = (rule,) if isinstance(rule, str) else tuple(rule)
        fresh = tuple(m for m in mesh_axes if m not in used)
        if not fresh:
            parts.append(None)
            continue
        used.update(fresh)
        parts.append(fresh[0] if len(fresh) == 1 else fresh)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def mesh_filtered_spec(spec: Spec, axis_names: Sequence[str]) -> Spec:
    """Drop mesh axes not in ``axis_names`` (so one rule table serves meshes
    of any dimensionality)."""
    parts = []
    for p in spec:
        if p is None:
            parts.append(None)
        elif isinstance(p, str):
            parts.append(p if p in axis_names else None)
        else:
            kept = tuple(m for m in p if m in axis_names)
            parts.append(kept[0] if len(kept) == 1 else (kept or None))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def shard_dim(axes: Sequence[Optional[str]], axis_names: Sequence[str], mesh_axis: str,
              rules: Optional[Rules] = None) -> Optional[int]:
    """The dimension the rules shard over ``mesh_axis`` (None: replicated)."""
    spec = mesh_filtered_spec(logical_spec(axes, rules), axis_names)
    for dim, part in enumerate(spec):
        if part == mesh_axis or (isinstance(part, tuple) and mesh_axis in part):
            return dim
    return None


def fsdp_dim(axes: Sequence[Optional[str]], axis_names: Sequence[str],
             rules: Optional[Rules] = None) -> Optional[int]:
    """The dimension the rules shard over ``fsdp`` (None: replicated)."""
    return shard_dim(axes, axis_names, AXIS_FSDP, rules)


def check_head_split(n_heads: int, n_kv_heads: int, tp: int) -> None:
    """Heads split over ``tensor`` only when both counts divide by it: a
    rank's q heads must read its own kv heads. (The JAX package replicates
    the heads then; the port splits weight columns, which cannot cut a
    head.)"""
    if n_heads % tp or n_kv_heads % tp:
        raise ValueError(
            f"tensor={tp} does not divide n_heads={n_heads} and n_kv_heads={n_kv_heads}: "
            "each tensor rank must hold whole q heads and the kv heads they read"
        )


def _split_over_tensor(model, tp_mesh, dims: Dict[str, int]) -> None:
    """Replace each parameter named in ``dims`` by a DTensor over
    ``tp_mesh``, ``Shard`` on its dimension there: this rank keeps its
    contiguous 1/N of the (identical on every rank) full tensor."""
    from torch import nn
    from torch.distributed.tensor import DTensor, Shard

    n = tp_mesh.size()
    i = tp_mesh.get_local_rank()
    for name, dim in dims.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        p = getattr(owner, leaf)
        if p.shape[dim] % n:
            raise ValueError(f"{name} {tuple(p.shape)}: dim {dim} does not split over tensor={n}")
        local = p.detach().chunk(n, dim)[i].contiguous()
        setattr(owner, leaf, nn.Parameter(
            DTensor.from_local(local, tp_mesh, [Shard(dim)], run_check=False)))


def shard_model(model, mesh, rules: Optional[Rules] = None):
    """Shard a model over the mesh, in place. The model says how, through
    three methods: ``logical_axes()`` (parameter name → logical axes),
    ``set_parallel(mesh)`` (checks the plan and takes the process groups it
    computes over) and ``fsdp_units()`` (the submodules FSDP2 wraps before
    the root): the Llama's are its decoder layers, a ResNet's its bottleneck
    blocks, MNIST's none.

    1. ``tensor`` (above 1): each parameter the rules send there becomes a
       DTensor on the ``tensor`` sub-mesh, ``Shard`` on that dimension (the
       Llama's ``wq``/``wk``/``wv``/``w_gate``/``w_up`` and ``lm_head`` on
       dim 1, ``wo``/``w_down`` and ``embed`` on dim 0); the model runs on
       the local shards and calls the tensor collectives itself.
    2. FSDP2 over (``data``, ``fsdp``): ``fully_shard`` on each unit, then
       on the root. ``data`` replicates and ``fsdp`` shards (HSDP when both
       are above 1), each parameter on its ``fsdp`` dimension per the rules
       (``embed``: dim 0 of ``wq``, dim 1 of ``wo``; ``conv_out``: dim 0 of
       an OIHW convolution). Parameters stay whole over ``sequence``, as the
       rules leave them; the trainer sums their gradients over it.

    ``expert`` and ``pipe`` are replica axes of the Llama path, as in the
    JAX package, whose Llama names neither axis: FSDP2 runs on the
    (``data``, ``fsdp``) sub-mesh of each of their coordinates, the rows
    split over ``data`` × ``fsdp`` only, so every rank of one (``data``,
    ``fsdp``, ``tensor``, ``sequence``) coordinate computes the same step
    on the same parameters and nothing is reduced over them.

    A parameter the rules replicate (the norm scales, batch norm's scale
    and bias) stays whole on every rank, outside FSDP, and the trainer
    reduces its gradient. Returns those replicated parameters, in the
    model's order (every rank must reduce them in one order)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    sizes = mesh_sizes(mesh)
    names = mesh.mesh_dim_names
    axes = model.logical_axes()
    model.set_parallel(mesh)
    if sizes.get(AXIS_TENSOR, 1) > 1:
        tp_dims = {n: shard_dim(axes[n], names, AXIS_TENSOR, rules) for n in axes}
        _split_over_tensor(model, mesh[AXIS_TENSOR],
                           {n: d for n, d in tp_dims.items() if d is not None})
    dp_mesh = batch_mesh(mesh)
    dims = {p: fsdp_dim(axes[n], names, rules) for n, p in model.named_parameters()}
    replicated = [p for p in model.parameters() if dims[p] is None]

    def placement(param):
        return Shard(dims[param])

    for unit in model.fsdp_units():
        fully_shard(unit, mesh=dp_mesh, shard_placement_fn=placement,
                    ignored_params=set(replicated) & set(unit.parameters()))
    fully_shard(model, mesh=dp_mesh, shard_placement_fn=placement, ignored_params=set(replicated))
    return replicated
