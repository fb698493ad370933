"""The routed expert products' share of their roofline, in %: the FLOPs the
traced steps need of them (``flops/deepseek_v3.py``'s ``routed``: the three
products of each of the T·k assignments, forward and the backward's two per
product; no padding rows, no recompute) at the card's dense bf16 peak, over
the summed device time of the grouped-product kernels (``torch._grouped_mm``:
CUTLASS's grouped GEMM, by name)."""

from benchmark.trace import has_part

GROUPED = ("GroupProblemShape",)


def read(run):
    peak = run.peak("bf16_flops")
    if run.trace is None or run.unit != "tokens" or peak is None:
        return None
    seconds = run.trace.time_s(lambda n: has_part(n, GROUPED))
    if seconds <= 0:
        return None
    t = run.cell.traffic
    need = run.flops().step_flops(run.cell.config, int(t["seq_len"]), int(t["global_batch"]))
    if "routed" not in need:  # a family with no routed experts
        return None
    return 100.0 * need["routed"] / run.chips * run.trace.steps / peak / seconds
