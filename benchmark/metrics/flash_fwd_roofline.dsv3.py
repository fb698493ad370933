"""K1's share of its roofline, in %: the forward attention FLOPs the traced
steps need (``flops/deepseek_v3.py``'s ``attention_fwd``: Q.K^T over the
q/k width and P.V over the v width, on the causal pairs) at the card's dense
bf16 peak, over the summed device time of K1 (``flash_fwd_kernel``; in
this cell its <192, 0, 128> instance). K1 runs once a layer a step (the
remat keeps its output), so no recompute is in its time."""

from benchmark.trace import has_part

KERNELS = ("flash_fwd_kernel",)


def read(run):
    peak = run.peak("bf16_flops")
    if run.trace is None or run.unit != "tokens" or peak is None:
        return None
    seconds = run.trace.time_s(lambda n: has_part(n, KERNELS))
    if seconds <= 0:
        return None
    t = run.cell.traffic
    need = run.flops().step_flops(run.cell.config, int(t["seq_len"]), int(t["global_batch"]))
    if "attention_fwd" not in need:
        return None
    return 100.0 * need["attention_fwd"] / run.chips * run.trace.steps / peak / seconds
