"""K1-K3's share of their roofline, in %: the causal attention FLOPs the
traced steps need (the forward's two products and the backward's four, on
the pairs at or below the diagonal, ``flops/decoder.py``) at the card's
dense bf16 peak, over the summed device time of the three kernels. The
work is counted from shapes, so it reads the same whatever kernel computes
attention; attention is bound by operations at these shapes, not bytes."""

from benchmark.trace import has_part

KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def read(run):
    peak = run.peak("bf16_flops")
    if run.trace is None or run.unit != "tokens" or peak is None:
        return None
    seconds = run.trace.time_s(lambda n: has_part(n, KERNELS))
    if seconds <= 0:
        return None
    t = run.cell.traffic
    need = run.flops().step_flops(run.cell.config, int(t["seq_len"]), int(t["global_batch"]))
    return 100.0 * need["attention"] / run.chips * run.trace.steps / peak / seconds
