"""Logical-axis sharding rules, and FSDP2 sharding of the Llama model.

Port of ``mpi_operator_tpu/parallel/sharding.py``. ``DEFAULT_RULES``,
:func:`logical_spec` and :func:`mesh_filtered_spec` are copies with the
same semantics (a mesh axis is used at most once; axes the mesh lacks are
dropped); a spec is a plain tuple here, one entry per array dimension
(None, a mesh axis name, or a tuple of them), trailing Nones dropped as
``PartitionSpec`` drops them.

:func:`shard_model` turns the rules into FSDP2: each parameter is sharded
on the dimension whose logical axis the rules send to ``fsdp``, so the
parameter layout is the JAX package's. The JAX package's
``with_logical_constraint`` has no counterpart: under FSDP2 every
activation is rank-local (this rank's batch, whole parameters gathered for
the layer that runs), and there is no partitioner to steer.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

from mpi_operator_tpu_torch.runtime.topology import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPE,
    AXIS_SEQ,
    AXIS_TENSOR,
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

# mesh axes the port cannot shard over yet, and the slice that brings each
UNPORTED_AXES = {
    AXIS_TENSOR: "the tensor-parallel slice (DTensor TP plans)",
    AXIS_SEQ: "the ring-attention slice (parallel/ring_attention.py)",
    AXIS_EXPERT: "the MoE slice (parallel/moe.py)",
    AXIS_PIPE: "the pipeline slice (parallel/pipeline.py)",
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


def refuse_unported_axes(sizes: Mapping[str, int]) -> None:
    """Raise ``NotImplementedError`` for a mesh axis above 1 that the port
    cannot shard over yet, naming the slice that brings it."""
    for axis, slice_name in UNPORTED_AXES.items():
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"mesh axis {axis}={sizes[axis]} is not ported to the PyTorch "
                f"package yet: it comes with {slice_name}"
            )


def fsdp_dim(axes: Sequence[Optional[str]], axis_names: Sequence[str],
             rules: Optional[Rules] = None) -> Optional[int]:
    """The dimension the rules shard over ``fsdp`` (None: replicated)."""
    spec = mesh_filtered_spec(logical_spec(axes, rules), axis_names)
    for dim, part in enumerate(spec):
        if part == AXIS_FSDP or (isinstance(part, tuple) and AXIS_FSDP in part):
            return dim
    return None


def shard_model(model, mesh, rules: Optional[Rules] = None):
    """Shard a :class:`~mpi_operator_tpu_torch.models.llama.Llama` over the
    mesh's (``data``, ``fsdp``) dimensions with FSDP2: ``fully_shard`` on
    each decoder layer, then on the root. ``data`` replicates and ``fsdp``
    shards (HSDP when both are above 1). Each parameter shards on its
    ``fsdp`` dimension per the rules (``embed``: dim 0 of ``wq``, dim 1 of
    ``wo``); a parameter the rules replicate (the norm scales) stays whole
    on every rank, outside FSDP, and the trainer averages its gradient.
    Returns those replicated parameters, in the model's order (every rank
    must reduce them in one order)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from mpi_operator_tpu_torch.models.llama import logical_axes

    sizes = mesh_sizes(mesh)
    refuse_unported_axes(sizes)
    names = mesh.mesh_dim_names
    dp_mesh = mesh[AXIS_FSDP] if sizes[AXIS_DATA] == 1 else mesh[AXIS_DATA, AXIS_FSDP]
    axes = logical_axes(model.config)
    dims = {p: fsdp_dim(axes[n], names, rules) for n, p in model.named_parameters()}
    replicated = [p for p in model.parameters() if dims[p] is None]

    def placement(param):
        return Shard(dims[param])

    for layer in model.layers:
        fully_shard(layer, mesh=dp_mesh, shard_placement_fn=placement,
                    ignored_params=set(replicated) & set(layer.parameters()))
    fully_shard(model, mesh=dp_mesh, shard_placement_fn=placement, ignored_params=set(replicated))
    return replicated
