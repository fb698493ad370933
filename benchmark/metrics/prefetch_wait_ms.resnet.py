"""Host milliseconds per traced step that the consumer of
``ops.data.prefetch`` waited for the next batch, read from the port's own
span ``data.wait`` (``runtime/stepstats.span_totals``, which counts spans
only during a capture): the in-program twin of ``input_wait_ms.resnet``.
Nothing where the program has no such span, or where the span did not
close once per traced step."""


def read(run):
    if run.trace is None or run.unit != "images":
        return None
    try:
        from mpi_operator_tpu_torch.runtime.stepstats import span_totals
    except ImportError:
        return None
    wait = span_totals().get("data.wait")
    if wait is None or wait["count"] != run.trace.steps:
        return None
    return 1e3 * wait["seconds"] / run.trace.steps
