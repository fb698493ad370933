"""The whole step's share of the card's dense bf16 peak, in %: the needed
FLOPs of a step (``flops/deepseek_v3.py``: 3x the forward's products, the
routed experts on the T·k assignments alone, and attention on the causal
pairs at the q/k and v widths, no padding and no recompute) times the
window's steps per second, over the cell's cards and the peak."""


def read(run):
    peak = run.peak("bf16_flops")
    if run.unit != "tokens" or peak is None:
        return None
    t = run.cell.traffic
    flops = run.flops().step_flops(run.cell.config, int(t["seq_len"]), int(t["global_batch"]))
    return 100.0 * flops["total"] * run.steps / run.window_s / run.chips / peak
