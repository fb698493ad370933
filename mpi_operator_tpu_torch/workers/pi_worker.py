"""SPMD π worker (≙ the reference's examples/pi/pi.cc).

Port of ``examples/pi_worker.py``. Every rank draws ``n`` points in the unit
square from its own ``torch.Generator`` (seeded with its global rank: the
host id at one chip per host), counts those inside the quarter circle, and
the counts are summed over the gang (≙ ``MPI_Reduce``); host 0 prints the
estimate. JAX's threefry draws are not reproducible here, so the estimate
is the JAX worker's only within Monte Carlo error.

    python -m mpi_operator_tpu_torch.workers.pi_worker [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Mapping, Optional, Union

import torch
import torch.distributed as dist

from mpi_operator_tpu_torch.parallel import collectives
from mpi_operator_tpu_torch.runtime import bootstrap
from mpi_operator_tpu_torch.runtime.topology import mesh_from_context
from mpi_operator_tpu_torch.workers import host


def main(n: int = 200_000, device: Union[str, torch.device, None] = None,
         environ: Optional[Mapping[str, str]] = None, local_rank: int = 0) -> float:
    """The estimate of π over every rank's ``n`` points (printed by host 0's
    first rank)."""
    env = os.environ if environ is None else environ
    ctx = bootstrap.context_from_env(env)
    device = bootstrap.initialize(ctx, device=device, environ=env, local_rank=local_rank)
    try:
        gang = dist.is_initialized()
        if gang:
            mesh_from_context(ctx, None, device.type)  # the gang and the plan agree
        rank, world = (dist.get_rank(), dist.get_world_size()) if gang else (0, 1)
        gen = torch.Generator(device=device).manual_seed(rank)
        pts = torch.rand(n, 2, generator=gen, device=device)
        inside = (pts.square().sum(1) < 1.0).sum().to(torch.float64)
        if gang:
            inside = collectives.psum(inside, dist.group.WORLD)
        pi = 4.0 * float(inside) / (n * world)
    finally:
        bootstrap.shutdown()
    if ctx.is_coordinator and local_rank == 0:
        print(f"pi is approximately {pi:.8f} ({ctx.num_hosts} hosts)", flush=True)
    return pi


def rank_main(local_rank: int, device: Optional[str], n: int) -> int:
    main(n, device=device, local_rank=local_rank)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=200_000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu: run on the CPU explicitly (default: cuda)")
    args = ap.parse_args()
    sys.exit(host.run_host(rank_main, args.device, (args.n,)))
