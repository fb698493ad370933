"""Set-up seconds: from the process's start (taken before ``import torch``) to
the window's start. It holds the imports, CUDA's start, loading (or, in a
checkout's first run, building) the kernel libraries, drawing the weights
and the traffic's pool, building the model and optimizer state, and the
first steps that warm every shape up and that the reference is held to."""


def read(run):
    return run.setup_s
