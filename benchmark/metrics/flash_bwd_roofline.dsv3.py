"""The attention backward's share of its roofline, in %: the backward FLOPs
the traced steps need (``flops/deepseek_v3.py``'s ``attention_bwd``: dP and
dV over the v width, dQ and dK over the q/k width, on the causal pairs; K3's
recompute of the scores is not needed work) at the card's dense bf16 peak,
over the summed device time of K3 (``flash_bwd_dkv_kernel``, in this cell
its kernel for the (192, 128) pair, ``flash_bwd_dkv_kernel_dv``) and the dq
pass (``flash_bwd_dq_kernel``)."""

from benchmark.trace import has_part

KERNELS = ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")


def read(run):
    peak = run.peak("bf16_flops")
    if run.trace is None or run.unit != "tokens" or peak is None:
        return None
    seconds = run.trace.time_s(lambda n: has_part(n, KERNELS))
    if seconds <= 0:
        return None
    t = run.cell.traffic
    need = run.flops().step_flops(run.cell.config, int(t["seq_len"]), int(t["global_batch"]))
    if "attention_bwd" not in need:
        return None
    return 100.0 * need["attention_bwd"] / run.chips * run.trace.steps / peak / seconds
