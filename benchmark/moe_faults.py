"""Two faults of a token-choice MoE planted underneath the program, to show
that an MoE cell's limits catch them: its readings on the card beside the
reference's, as ``benchmark.calibrate`` prints them.

    python3 -m benchmark.moe_faults --workload <cell> --seeds 1,2 --fault no_shared|top7

- ``no_shared``: the shared expert left out (its output times zero, so its
  weights get zero gradients);
- ``top7``: each token routed to one expert fewer than the configuration's
  top-k, its weights normalised over those.

Each seed's line is ``benchmark.calibrate``'s (its ``fault`` field empty),
after a line naming the fault. None of this is reachable from
``benchmark.run``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("no_shared", "top7")


@contextlib.contextmanager
def planted(name: str):
    """Plant fault ``name`` in the program's MoE layer for the ``with`` block."""
    from mpi_operator_tpu_torch.parallel import moe

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")
    real_shared, real_route = moe.TokenChoiceMoE._shared, moe.route

    def no_shared(self, x):
        return real_shared(self, x) * 0

    def one_fewer(scores, bias, config):
        return real_route(scores, bias, dataclasses.replace(config, top_k=config.top_k - 1))

    try:
        if name == "no_shared":
            moe.TokenChoiceMoE._shared = no_shared
        else:
            moe.route = one_fewer
        yield
    finally:
        moe.TokenChoiceMoE._shared, moe.route = real_shared, real_route


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--fault", required=True, choices=FAULTS)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import calibrate, harness

    os.environ.update(harness.cache_dirs(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("moe_faults: needs a CUDA card", file=sys.stderr)
        return 2
    from mpi_operator_tpu_torch.runtime import bootstrap

    device = bootstrap.initialize(device="cuda")
    print(json.dumps({"workload": args.workload, "planted": args.fault}), flush=True)
    with planted(args.fault):
        calibrate.lines(device, None, args.workload, ROOT,
                        [int(s) for s in args.seeds.split(",")], False, "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
