"""Host milliseconds per step blocked in ``next()`` on the ``ops.data.prefetch``
iterator, taken by the benchmark's own clock around the call, over the
window's steps."""


def read(run):
    if not run.input_wait_s:
        return None
    return 1e3 * sum(run.input_wait_s) / len(run.input_wait_s)
