"""The job's mesh: a :class:`MeshPlan` of named axes → a ``DeviceMesh``.

Port of ``mpi_operator_tpu/runtime/topology.py``. The axis vocabulary,
``MESH_AXES``, :class:`MeshPlan` and the slice-major layout of
:func:`_hybrid_flat_mesh` are copies (a manifest's ``LLAMA_MESH`` means the
same plan to either worker). What differs is the mesh: a
``torch.distributed`` ``DeviceMesh`` over the ranks of the process group
(``runtime/bootstrap.py`` forms it), with its dimensions named in canonical
order.

- ``data``      batch sharding (pure DP; gradients averaged over it)
- ``fsdp``      batch + parameter sharding (FSDP2, ZeRO-3-style)
- ``tensor``    megatron-style tensor parallelism
- ``sequence``  context/sequence parallelism (ring attention)
- ``expert``    MoE expert parallelism
- ``pipe``      pipeline stages

The port shards over ``data`` and ``fsdp`` only (parallel/sharding.py);
the other four come with later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_SEQ = "sequence"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"
AXIS_TENSOR = "tensor"

# Canonical ordering, outermost (cheapest to put on the slow network,
# reduced least often) to innermost (hottest collectives).
MESH_AXES: Tuple[str, ...] = (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_PIPE,
    AXIS_EXPERT,
    AXIS_SEQ,
    AXIS_TENSOR,
)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Logical mesh layout: axis name → size. ``dcn`` gives the per-axis
    slice-count for multi-slice meshes; only leading axes may cross the
    slices."""

    axes: Dict[str, int] = dataclasses.field(default_factory=dict)
    dcn: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for name in list(self.axes) + list(self.dcn):
            if name not in MESH_AXES:
                raise ValueError(
                    f"unknown mesh axis {name!r}; the vocabulary is {MESH_AXES}"
                )

    @property
    def ici_size(self) -> int:
        return math.prod(self.axes.values()) if self.axes else 1

    @property
    def dcn_size(self) -> int:
        return math.prod(self.dcn.values()) if self.dcn else 1

    @property
    def total_devices(self) -> int:
        return self.ici_size * self.dcn_size

    def ordered(self) -> Tuple[Tuple[str, int], ...]:
        """All axes in canonical order with combined (dcn*ici) sizes."""
        out = []
        for name in MESH_AXES:
            size = self.axes.get(name, 1) * self.dcn.get(name, 1)
            if size > 1 or name in self.axes or name in self.dcn:
                out.append((name, size))
        if not out:
            out.append((AXIS_DATA, 1))
        return tuple(out)

    @staticmethod
    def data_parallel(n: int) -> "MeshPlan":
        return MeshPlan(axes={AXIS_DATA: n})

    @staticmethod
    def parse(spec: str, dcn: str = "") -> "MeshPlan":
        """Parse a parallelism spec from a job manifest / env var —
        ``"fsdp=4,tensor=2"`` (within-slice axes) plus an optional DCN spec
        like ``"data=2"`` (slice counts on leading axes)."""

        def parse_axes(s: str) -> Dict[str, int]:
            out: Dict[str, int] = {}
            for part in (p.strip() for p in s.split(",") if p.strip()):
                name, _, size = part.partition("=")
                name = name.strip()
                if name in out:
                    raise ValueError(f"duplicate mesh axis {name!r} in {s!r}")
                try:
                    out[name] = int(size)
                except ValueError:
                    raise ValueError(
                        f"bad mesh spec entry {part!r}; expected axis=N"
                    ) from None
                if out[name] < 1:
                    raise ValueError(f"bad mesh axis size in {part!r}")
            return out

        return MeshPlan(axes=parse_axes(spec), dcn=parse_axes(dcn))


def _hybrid_flat_mesh(
    ici_shape: Sequence[int], dcn_shape: Sequence[int], devices
) -> np.ndarray:
    """Hybrid mesh layout: devices (here, ranks) arrive slice-major (slice i
    owns the i-th contiguous block of ici_size ranks), and each logical axis
    of combined size dcn*ici is laid out [dcn, ici] with the slice factor
    outermost — so a collective along an axis with dcn==1 never leaves its
    slice."""
    n = len(ici_shape)
    arr = np.asarray(devices).reshape(tuple(dcn_shape) + tuple(ici_shape))
    perm = [a for i in range(n) for a in (i, n + i)]
    arr = arr.transpose(perm)
    return arr.reshape(tuple(d * i for d, i in zip(dcn_shape, ici_shape)))


def mesh_axes(plan: MeshPlan) -> Tuple[Tuple[str, int], ...]:
    """The torch mesh's dimensions: ``plan.ordered()`` plus ``data`` and
    ``fsdp`` at size 1 where the plan omits them, since FSDP2 takes its
    (replicate, shard) mesh from those two."""
    sizes = dict(plan.ordered())
    sizes.setdefault(AXIS_DATA, 1)
    sizes.setdefault(AXIS_FSDP, 1)
    return tuple((name, sizes[name]) for name in MESH_AXES if name in sizes)


def build_mesh(plan: MeshPlan, device_type: str):
    """Materialize the plan as a ``DeviceMesh`` over the process group's
    ranks (``device_type`` "cuda" or "cpu"). Without slice factors the
    ranks are laid out row-major; with them, as :func:`_hybrid_flat_mesh`
    lays them out."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    names = tuple(n for n, _ in mesh_axes(plan))
    sizes = tuple(s for _, s in mesh_axes(plan))
    world = dist.get_world_size()
    total = math.prod(sizes)
    if total != world:
        raise ValueError(
            f"mesh plan wants {total} devices ({dict(plan.ordered())}) but "
            f"{world} ranks are in the process group — gang placement and plan disagree"
        )
    if plan.dcn_size > 1:
        ici_shape = [plan.axes.get(n, 1) for n in names]
        dcn_shape = [plan.dcn.get(n, 1) for n in names]
        ranks = _hybrid_flat_mesh(ici_shape, dcn_shape, np.arange(world))
        return DeviceMesh(device_type, torch.as_tensor(ranks), mesh_dim_names=names)
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name → size of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_from_context(ctx, plan: Optional[MeshPlan] = None, device_type: str = "cuda"):
    """Build the job-wide mesh for a bootstrapped gang.

    With no explicit plan, defaults to pure data parallelism over every rank;
    for a multi-slice gang (``ctx.num_slices > 1``) the slice count goes on
    the data axis's slice factor.

    Fails fast when the gang the controller declared (num_hosts ×
    chips_per_host) disagrees with the process group after rendezvous."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if ctx is not None and ctx.chips_per_host:
        expected = ctx.num_hosts * ctx.chips_per_host
        if expected != world:
            raise RuntimeError(
                f"gang declares {ctx.num_hosts} hosts × {ctx.chips_per_host} "
                f"chips = {expected} devices but the process group has "
                f"{world} ranks — rendezvous and placement disagree"
            )
    ns = getattr(ctx, "num_slices", 1) if ctx is not None else 1
    if plan is None:
        if ns > 1 and world % ns == 0:
            plan = MeshPlan(axes={AXIS_DATA: world // ns}, dcn={AXIS_DATA: ns})
        else:
            plan = MeshPlan.data_parallel(world)
    elif ns > 1 and plan.dcn_size != ns:
        # an explicit plan on a multi-slice gang MUST name the slice factor:
        # flattening the slices would let inner mesh axes span the slice
        # boundary
        raise ValueError(
            f"gang spans {ns} slices but the mesh plan's DCN factor is "
            f"{plan.dcn_size}; declare it (e.g. LLAMA_MESH_DCN='data={ns}')"
        )
    return build_mesh(plan, device_type)
