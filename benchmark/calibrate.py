"""The readings a cell's limits are set from, on the card.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--control | --fault F]

For each seed, in one process (one per card for a cell on several cards):
the program's readings of its first steps
(set-up as a run makes it, no window); with ``--control``, the control's
instead (the family's ``control``: the program's lower-precision path where
it has one, else the reference in that precision); with ``--fault``, the
program's with a fault of ``benchmark.faults`` planted. Then the
reference's. Prints one JSON line per seed with every number compared, its
five worst leaves, and the seconds each side took. The sound runs' largest
number is a limit's lower reading; the control's smallest, and a fault's
where it reads far above, its upper one.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worst(prog: dict, ref: dict, n: int = 5):
    """The ``n`` leaves with the largest gap of norms as the comparison takes
    it (``readings``), as (name, program's norm, reference's norm)."""
    floor = statistics.median(ref.values())
    names = sorted(ref, key=lambda k: -abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30))
    return [[k, prog[k], ref[k]] for k in names[:n]]


def readings_of(cell, seed: int, device, control: bool, fault: str = "", mesh=None):
    import contextlib

    import torch

    from benchmark import faults, spec

    fam = spec.family(cell.family)
    steps = int(cell.spec["reference_steps"])
    t = time.perf_counter()
    if control:
        prog = fam.control(cell, seed, device, steps, mesh=mesh)
    else:
        session = fam.Session(cell, seed, device, mesh=mesh)
        try:
            with faults.planted(fault) if fault else contextlib.nullcontext():
                prog = session.first_steps(steps)
        finally:
            session.close()
            del session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_prog = time.perf_counter() - t
    t = time.perf_counter()
    extra = {"layouts": prog["layouts"]} if "layouts" in prog else {}
    ref = fam.reference(cell, seed, device, steps, **extra)
    return prog, ref, t_prog, time.perf_counter() - t


def lines(device, mesh, name: str, root: str, seeds, control: bool, fault: str):
    """Each seed's line (printed by the first rank as it comes)."""
    import torch
    import torch.distributed as dist

    from benchmark import readings, spec

    cell = spec.load_cell(name, root)
    first = not dist.is_initialized() or dist.get_rank() == 0
    for seed in seeds:
        prog, ref, t_prog, t_ref = readings_of(cell, seed, device, control, fault, mesh)
        numbers = readings.compare(prog, ref)
        line = {"workload": cell.name, "seed": seed, "control": control, "fault": fault,
                "numbers": {k: v["value"] for k, v in numbers.items()},
                "losses": [prog["losses"], ref["losses"]],
                "worst": {k: worst(prog[k], ref[k]) for k in ("grad", "change", "stats")
                          if k in ref},
                "program_s": t_prog, "reference_s": t_ref,
                "card": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
        if first:
            print(json.dumps(line), flush=True)
        del prog, ref
        gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default="", help="one of benchmark.faults.FAULTS")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness, spec

    os.environ.update(harness.cache_dirs(ROOT))
    import torch

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate: {cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    job = (cell.name, ROOT, seeds, args.control, args.fault)
    if cell.chips > 1:
        harness.in_gang(lines, cell, job, timeout=3000.0)
        return 0
    from mpi_operator_tpu_torch.runtime import bootstrap

    lines(bootstrap.initialize(device="cuda"), None, *job)
    return 0


if __name__ == "__main__":
    sys.exit(main())
