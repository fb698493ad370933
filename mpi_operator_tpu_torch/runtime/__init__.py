"""Single-host runtime: the worker's context and its device."""

from mpi_operator_tpu_torch.runtime.bootstrap import (
    RuntimeContext,
    context_from_env,
    initialize,
    resolve_device,
)
