"""Runtime: the worker's context, its rendezvous and device, and the mesh."""

from mpi_operator_tpu_torch.runtime.bootstrap import (
    RuntimeContext,
    context_from_env,
    initialize,
    resolve_device,
)
from mpi_operator_tpu_torch.runtime.topology import MeshPlan, build_mesh, mesh_from_context
