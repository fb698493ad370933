"""One host's ranks, as the executor launches a worker: one process per
host, one rank per local chip.

:func:`run_host` runs ``rank_main(local_rank, device, *args)`` (which
returns the rank's exit code) in this process when the host has one chip, else in
``chips_per_host`` spawned processes (``bootstrap.run_local_ranks``), and
combines their codes: 75 (``EXIT_RESTART``) if any rank asked for a
restart, else the first non-zero code. A one-host gang without a
coordinator address gets a free localhost port.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Iterable, Optional

from mpi_operator_tpu_torch.ops.elastic import EXIT_RESTART
from mpi_operator_tpu_torch.runtime import bootstrap


def combined_exit(codes: Iterable[Optional[int]]) -> int:
    """75 if any rank asked for a restart, else the first non-zero code."""
    codes = list(codes)
    if EXIT_RESTART in codes:
        return EXIT_RESTART
    return next((c for c in codes if c), 0)


def _exit_with(local_rank: int, rank_main: Callable, device: Optional[str], args: tuple) -> None:
    sys.exit(rank_main(local_rank, device, *args))


def run_host(rank_main: Callable[..., int], device: Optional[str] = None,
             args: tuple = ()) -> int:
    """This host's ranks (module docstring); returns the host's exit code.
    ``rank_main`` must be a module-level function (the spawned ranks
    import it)."""
    ctx = bootstrap.context_from_env()
    local = max(ctx.chips_per_host, 1) if device == "cpu" else ctx.local_chips()
    if local <= 1:
        return rank_main(0, device, *args)
    if ctx.num_hosts == 1 and not ctx.coordinator_address:
        os.environ[bootstrap.ENV_COORDINATOR] = f"127.0.0.1:{bootstrap.free_port()}"
    return combined_exit(bootstrap.run_local_ranks(_exit_with, local,
                                                   (rank_main, device, args)))
