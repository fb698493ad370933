"""``matmul_roofline.decoder``'s reading in a cell on several cards (the worst rank's), where
it moves the gang's own rate, ``tokens_per_s_per_gpu.fsdp``; nothing on
one card."""

from benchmark import spec


def read(run):
    if run.chips < 2:
        return None
    return spec.metric_reader("matmul_roofline.decoder", run.root).read(run)
