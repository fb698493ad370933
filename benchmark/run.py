"""Run one cell of the port's benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks`` last: each number compared with its limit);
the last lines on standard error repeat the checks. Without CUDA, with
fewer cards than the cell asks for, or when the process (or a rank of a
cell on several cards) holds JAX or the JAX package once the window has
closed, it prints no result and exits with a non-zero code.
"""

import time

T0 = time.perf_counter()  # the process's start, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness, spec

    os.environ.update(harness.cache_dirs(ROOT))
    import torch

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); {have} found",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        try:
            out, extra = harness.execute_ranks(args.workload, args.seed, args.seconds,
                                               bool(args.trace), T0, ROOT)
        except RuntimeError as e:
            print(f"benchmark: {e}", file=sys.stderr)
            return 4
    else:
        from mpi_operator_tpu_torch.runtime import bootstrap

        device = bootstrap.initialize(device="cuda")
        out, extra = harness.execute(args.workload, args.seed, args.seconds,
                                     bool(args.trace), device, T0, ROOT)
    found = sorted(set(extra["forbidden"]) | set(harness.forbidden_modules(sys.modules)))
    if found:
        print(f"benchmark: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    print("seconds " + " ".join(f"{k} {v!r}" for k, v in extra["seconds"].items()),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {c['leaf']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
