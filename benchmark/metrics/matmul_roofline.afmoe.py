"""The matrix products' share of their roofline outside the routed experts,
in %: the FLOPs the traced steps need of every product but the routed
experts' (``flops/afmoe.py``'s ``products`` less ``routed``: the q/k/v,
gate and output projections, the dense FFNs, the router, the shared expert
and the head, forward and the backward's two per product, no recompute) at
the card's dense bf16 peak, over the summed device time of cuBLAS's product
kernels, by name, less the grouped expert products' (CUTLASS's grouped
GEMM, which ``moe_gemm_roofline.afmoe`` reads)."""

from benchmark.trace import has_part

PRODUCTS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
GROUPED = ("GroupProblemShape",)


def read(run):
    peak = run.peak("bf16_flops")
    if run.trace is None or run.unit != "tokens" or peak is None:
        return None
    seconds = run.trace.time_s(lambda n: has_part(n, PRODUCTS) and not has_part(n, GROUPED))
    if seconds <= 0:
        return None
    t = run.cell.traffic
    need = run.flops().step_flops(run.cell.config, int(t["seq_len"]), int(t["global_batch"]))
    if "routed" not in need:  # a family with no routed experts
        return None
    dense = need["products"] - need["routed"]
    return 100.0 * dense / run.chips * run.trace.steps / peak / seconds
