"""The whole step's share of the card's peak in the configuration's
precision (dense bf16; float32 outside the tensor cores where TF32 is off),
in %: the needed FLOPs of a step (``flops/resnet.py``: 3x the forward's
convolutions and head) times the window's steps per second, over the
cell's cards and the peak."""

from benchmark.families.resnet import peak_key


def read(run):
    peak = run.peak(peak_key(run.cell.config))
    if run.unit != "images" or peak is None:
        return None
    flops = run.flops().step_flops(run.cell.config, int(run.cell.traffic["global_batch"]))
    return 100.0 * flops["total"] * run.steps / run.window_s / run.chips / peak
