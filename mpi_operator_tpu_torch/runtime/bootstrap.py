"""The worker's view of its gang, and the device it runs on.

Port of ``mpi_operator_tpu/runtime/bootstrap.py``. The ``TPUJOB_*`` names,
:class:`RuntimeContext`, :func:`context_from_env` and
:func:`default_checkpoint_dir` are copies: the controller injects the same
env into every worker whatever framework it runs.

Two rules differ from the JAX package on purpose:

- The device is never taken from ``TPUJOB_ACCELERATOR``. Entry points run on
  ``cuda`` unless the caller passes ``device="cpu"``, and raise when CUDA is
  missing; nothing falls back to the CPU.
- JAX runs one process per host; the port runs one per chip (a *rank*).
  The executor launches one process per host, and the worker spawns its
  ``chips_per_host`` local ranks (workers/llama_worker.py). Rank =
  ``host_id * local_chips + local_rank``; world = ``num_hosts *
  local_chips``. :func:`process_index` and :func:`process_count` keep the
  JAX meaning (the host and the number of hosts).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import signal
import socket
import time
from typing import Callable, List, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

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
# a rank's retryable exit: a membership change or SIGTERM (ops/elastic.py)
EXIT_RESTART = 75


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


# the gang this process joined (set by initialize, cleared by shutdown)
_active: Optional[RuntimeContext] = None
_local_rank = 0
_local_chips = 1

RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)


def _backend(device: torch.device) -> str:
    # the elastic loop's membership all-gather (and DCP's planning) runs on
    # CPU tensors: the card's group carries gloo for those beside NCCL
    return "cuda:nccl,cpu:gloo" if device.type == "cuda" else "gloo"


def initialize(
    ctx: Optional[RuntimeContext] = None,
    *,
    device: Union[str, torch.device, None] = None,
    environ: Optional[Mapping[str, str]] = None,
    local_rank: int = 0,
    group: bool = False,
) -> torch.device:
    """Join the gang and return the device to run on (see
    :func:`resolve_device`).

    A single-host run with one chip forms no process group unless asked
    (``group=True``: a mesh or checkpoints need one): the plain
    single-device path. Otherwise this process
    becomes rank ``host_id * local_chips + local_rank`` of a
    ``torch.distributed`` group, rendezvousing through a ``TCPStore`` at
    ``TPUJOB_COORDINATOR_ADDRESS`` (rank 0 serves it), on ``cuda:<local
    rank>`` with NCCL (and gloo for CPU tensors) or on the CPU with gloo.
    A one-rank group (one host, one chip, ``group=True``) serves its
    store on a free localhost port. A rendezvous or NCCL failure raises;
    nothing falls back to the CPU."""
    global _active, _local_rank, _local_chips
    if ctx is None:
        ctx = context_from_env(environ)
    # the persistent kernel cache (runtime/compile_cache.py): with the
    # executor's node-local dir, the kernels build there, before anything
    # launches one, and a relaunched gang loads them without nvcc
    from mpi_operator_tpu_torch.runtime import compile_cache

    compile_cache.configure_from_env(environ)
    dev = resolve_device(device)
    local = ctx.local_chips() if dev.type == "cuda" else max(ctx.chips_per_host, 1)
    world = ctx.num_hosts * local
    if world == 1 and not group:
        return dev
    if not 0 <= local_rank < local:
        raise ValueError(f"local rank {local_rank} outside this host's {local} chips")
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    rank = ctx.host_id * local + local_rank
    if world == 1:
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True, timeout=RENDEZVOUS_TIMEOUT)
    else:
        if not ctx.coordinator_address:
            raise RuntimeError(
                f"{ENV_NUM_HOSTS}={ctx.num_hosts} with {local} chips per host but "
                f"{ENV_COORDINATOR} is unset — the controller always injects both; "
                "refusing to guess"
            )
        host, _, port = ctx.coordinator_address.rpartition(":")
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                              timeout=RENDEZVOUS_TIMEOUT)
    dist.init_process_group(_backend(dev), store=store, rank=rank, world_size=world)
    _active, _local_rank, _local_chips = ctx, local_rank, local
    return dev


def shutdown() -> None:
    """Leave the gang (destroy the process group, if one was formed)."""
    global _active
    if dist.is_initialized():
        dist.destroy_process_group()
    _active = None


def free_port() -> int:
    """A free TCP port on localhost, for a one-host gang's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_local_ranks(target: Callable, n: int, args: tuple = (),
                    timeout: Optional[float] = None) -> List[Optional[int]]:
    """Run ``target(local_rank, *args)`` in ``n`` processes (the ``spawn``
    start method: each starts fresh, as a rank must) and return their exit
    codes. SIGTERM is forwarded to them; 10 s after one fails, or at
    ``timeout`` seconds, the rest are killed (a rank that died leaves the
    others waiting in a collective), and a killed rank's code is negative."""
    spawn = multiprocessing.get_context("spawn")
    procs = [spawn.Process(target=target, args=(r, *args)) for r in range(n)]

    def forward(sig, frame):
        for p in procs:
            if p.pid is not None and p.is_alive():
                os.kill(p.pid, sig)

    previous = signal.signal(signal.SIGTERM, forward)
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        failed_at = None
        while any(p.is_alive() for p in procs):
            for p in procs:
                p.join(timeout=0.2)
            if failed_at is None and any(p.exitcode not in (None, 0, EXIT_RESTART)
                                         for p in procs):
                failed_at = time.monotonic()
            now = time.monotonic()
            if (failed_at is not None and now - failed_at > 10.0) or \
                    (deadline is not None and now > deadline):
                for p in procs:
                    if p.is_alive():
                        p.kill()
    finally:
        signal.signal(signal.SIGTERM, previous)
    return [p.exitcode for p in procs]


def process_index() -> int:
    """This host's index in the gang (JAX's ``process_index``)."""
    return _active.host_id if _active is not None else 0


def process_count() -> int:
    """The number of hosts in the gang (JAX's ``process_count``)."""
    return _active.num_hosts if _active is not None else 1


def local_rank() -> int:
    """This process's rank among its host's chips."""
    return _local_rank if _active is not None else 0


def local_chips() -> int:
    """The ranks this host runs (1 without a gang)."""
    return _local_chips if _active is not None else 1
