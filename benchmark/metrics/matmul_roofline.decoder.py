"""The matrix products' share of their roofline, in %: the product FLOPs the
traced steps need (the forward's and the backward's two per product, no
recompute, ``flops/decoder.py``) at the card's dense bf16 peak, over the
summed device time of the product kernels (cuBLAS's, by name)."""

from benchmark.trace import has_part

PRODUCTS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")


def read(run):
    peak = run.peak("bf16_flops")
    if run.trace is None or run.unit != "tokens" or peak is None:
        return None
    seconds = run.trace.time_s(lambda n: has_part(n, PRODUCTS))
    if seconds <= 0:
        return None
    t = run.cell.traffic
    need = run.flops().step_flops(run.cell.config, int(t["seq_len"]), int(t["global_batch"]))
    return 100.0 * need["products"] / run.chips * run.trace.steps / peak / seconds
