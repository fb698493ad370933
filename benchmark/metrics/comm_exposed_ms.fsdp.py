"""Device milliseconds per traced step in which an NCCL kernel runs and no
other kernel does (copies and memsets aside): the collectives that FSDP2's
all-gathers and reduce-scatters leave exposed, on one rank (the line holds
the worst rank's)."""

from benchmark.trace import COPY_PARTS, has_part

NCCL = ("nccl",)


def read(run):
    if run.trace is None or run.chips < 2:
        return None
    if not any(has_part(n, NCCL) for n, _, _ in run.trace.device):
        return None
    seconds = run.trace.exposed_s(lambda n: has_part(n, NCCL),
                                  lambda n: not has_part(n, NCCL + COPY_PARTS))
    return 1e3 * seconds / run.trace.steps
