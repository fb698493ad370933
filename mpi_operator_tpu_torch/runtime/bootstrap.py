"""The worker's view of its gang, and the device it runs on.

Port of ``mpi_operator_tpu/runtime/bootstrap.py``. The ``TPUJOB_*`` names,
:class:`RuntimeContext`, :func:`context_from_env` and
:func:`default_checkpoint_dir` are copies: the controller injects the same
env into every worker whatever framework it runs.

Two rules differ from the JAX package on purpose:

- The device is never taken from ``TPUJOB_ACCELERATOR``. Entry points run on
  ``cuda`` unless the caller passes ``device="cpu"``, and raise when CUDA is
  missing; nothing falls back to the CPU.
- Only a single host is supported. Multi-host rendezvous
  (``torch.distributed``) comes with the mesh in a later slice.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional, Tuple, Union

import torch

ENV_JOB_NAME = "TPUJOB_NAME"
ENV_NAMESPACE = "TPUJOB_NAMESPACE"
ENV_COORDINATOR = "TPUJOB_COORDINATOR_ADDRESS"
ENV_NUM_HOSTS = "TPUJOB_NUM_HOSTS"
ENV_HOST_ID = "TPUJOB_HOST_ID"
ENV_CHIPS_PER_HOST = "TPUJOB_CHIPS_PER_HOST"
ENV_ACCELERATOR = "TPUJOB_ACCELERATOR"
ENV_TOPOLOGY = "TPUJOB_TOPOLOGY"
ENV_HOST_MESH = "TPUJOB_HOST_MESH"
ENV_HOST_COORD = "TPUJOB_HOST_COORD"
ENV_SLICE_ID = "TPUJOB_SLICE_ID"
ENV_NUM_SLICES = "TPUJOB_NUM_SLICES"
# node-local mount of the cluster's shared checkpoint volume (node agent's
# --ckpt-dir); a restarted gang may land on other nodes, so checkpoints live
# under it and never on a node-local path
ENV_CKPT_DIR = "TPUJOB_CKPT_DIR"


def _parse_shape(s: str) -> Tuple[int, ...]:
    return tuple(int(p) for p in s.split("x")) if s else ()


@dataclasses.dataclass(frozen=True)
class RuntimeContext:
    """One host's view of the gang, from the controller-injected env."""

    job_name: str = "local"
    namespace: str = "default"
    coordinator_address: str = ""
    num_hosts: int = 1
    host_id: int = 0
    chips_per_host: int = 0  # 0 = undeclared; local_chips() discovers
    accelerator: str = ""  # as declared by the controller; never picks the device
    topology: Tuple[int, ...] = ()
    host_mesh: Tuple[int, ...] = ()
    host_coord: Tuple[int, ...] = ()
    slice_id: int = 0
    num_slices: int = 1

    @property
    def is_distributed(self) -> bool:
        return self.num_hosts > 1

    @property
    def is_coordinator(self) -> bool:
        """Host 0 reports for the job."""
        return self.host_id == 0

    def local_chips(self) -> int:
        """Declared chips per host, else the CUDA devices this host sees."""
        if self.chips_per_host:
            return self.chips_per_host
        return torch.cuda.device_count()


def context_from_env(environ: Optional[Mapping[str, str]] = None) -> RuntimeContext:
    """Build the host's RuntimeContext from controller-injected env; absent
    env gives a single-host local context."""
    env = os.environ if environ is None else environ
    return RuntimeContext(
        job_name=env.get(ENV_JOB_NAME, "local"),
        namespace=env.get(ENV_NAMESPACE, "default"),
        coordinator_address=env.get(ENV_COORDINATOR, ""),
        num_hosts=int(env.get(ENV_NUM_HOSTS, "1")),
        host_id=int(env.get(ENV_HOST_ID, "0")),
        chips_per_host=int(env.get(ENV_CHIPS_PER_HOST, "0") or 0),
        accelerator=env.get(ENV_ACCELERATOR, ""),
        topology=_parse_shape(env.get(ENV_TOPOLOGY, "")),
        host_mesh=_parse_shape(env.get(ENV_HOST_MESH, "")),
        host_coord=_parse_shape(env.get(ENV_HOST_COORD, "")),
        slice_id=int(env.get(ENV_SLICE_ID, "0") or 0),
        num_slices=int(env.get(ENV_NUM_SLICES, "1") or 1),
    )


def default_checkpoint_dir(
    ctx: RuntimeContext,
    environ: Optional[Mapping[str, str]] = None,
) -> Optional[str]:
    """``<TPUJOB_CKPT_DIR>/<namespace>/<job>``, or None when the node agent
    advertised no shared checkpoint volume."""
    env = os.environ if environ is None else environ
    base = env.get(ENV_CKPT_DIR, "")
    if not base:
        return None
    return os.path.join(base, ctx.namespace, ctx.job_name)


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``cuda`` unless the caller names another device. Raises when CUDA is
    asked for (or implied) and missing: no silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU explicitly"
        )
    return dev


def initialize(
    ctx: Optional[RuntimeContext] = None,
    *,
    device: Union[str, torch.device, None] = None,
    environ: Optional[Mapping[str, str]] = None,
) -> torch.device:
    """Check that this is a single-host gang and return the device to run on
    (see :func:`resolve_device`)."""
    if ctx is None:
        ctx = context_from_env(environ)
    if ctx.is_distributed:
        raise NotImplementedError(
            f"{ENV_NUM_HOSTS}={ctx.num_hosts}: multi-host rendezvous is not ported "
            "to the PyTorch package yet (it comes with the mesh and FSDP slice)"
        )
    return resolve_device(device)
