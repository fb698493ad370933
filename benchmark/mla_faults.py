"""Two faults of multi-head latent attention planted underneath the program,
to show that an MLA cell's limits catch them: its readings on the card
beside the reference's, as ``benchmark.calibrate`` prints them.

    python3 -m benchmark.mla_faults --workload <cell> --seeds 1,2 --fault rope_half|no_latent_norm

- ``rope_half``: RoPE on q's and k's rope columns in halves (llama's
  rotation of column i with column i + Dr/2) instead of on adjacent pairs;
- ``no_latent_norm``: the latent c left unnormalised before its
  up-projection (its norm's scale then gets a zero gradient).

Each seed's line is ``benchmark.calibrate``'s (its ``fault`` field empty),
after a line naming the fault. None of this is reachable from
``benchmark.run``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("rope_half", "no_latent_norm")


@contextlib.contextmanager
def planted(name: str, kv_rank: int = 512):
    """Plant fault ``name`` in the program's DeepSeek-V3 layers for the
    ``with`` block; ``kv_rank`` is the latent's width, the one norm of it."""
    from mpi_operator_tpu_torch.models import deepseek_v3, llama

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")
    real_rope, real_norm = deepseek_v3.rope_interleaved, deepseek_v3._rmsnorm

    def skip_latent(x, scale, eps):  # the scale stays in the graph, with a zero gradient
        return x + 0 * scale.sum().to(x.dtype) if x.shape[-1] == kv_rank else real_norm(
            x, scale, eps)

    try:
        if name == "rope_half":
            deepseek_v3.rope_interleaved = llama._rope_bhtd
        else:
            deepseek_v3._rmsnorm = skip_latent
        yield
    finally:
        deepseek_v3.rope_interleaved, deepseek_v3._rmsnorm = real_rope, real_norm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--fault", required=True, choices=FAULTS)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import calibrate, harness, spec

    os.environ.update(harness.cache_dirs(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("mla_faults: needs a CUDA card", file=sys.stderr)
        return 2
    from mpi_operator_tpu_torch.runtime import bootstrap

    device = bootstrap.initialize(device="cuda")
    rank = int(spec.load_cell(args.workload, ROOT).config["kv_lora_rank"])
    print(json.dumps({"workload": args.workload, "planted": args.fault}), flush=True)
    with planted(args.fault, rank):
        calibrate.lines(device, None, args.workload, ROOT,
                        [int(s) for s in args.seeds.split(",")], False, "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
