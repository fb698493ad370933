"""``torch.cuda.max_memory_allocated`` over the whole run up to the end of the
window (the reference runs after it), in GiB: it guards the batch that fits,
so that memory traded for speed shows."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2 ** 30
