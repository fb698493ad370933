"""K1 and the backward's share of their roofline, in %: the attention FLOPs
the traced steps need (the forward's two products and the backward's four,
on the pairs inside each sliding layer's window and the causal pairs of
each full layer, ``flops/afmoe.py``) at the card's dense bf16 peak, over the
summed device time of K1, K3 and the dq pass (the windowed instances and
the causal ones alike). A kernel that computes pairs outside the window
reads low here."""

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
