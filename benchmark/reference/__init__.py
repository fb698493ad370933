"""Plain float32 PyTorch references of the benchmark's training steps.

They import nothing of the program (``mpi_operator_tpu_torch``), nor JAX:
each is written from the published equations and the configuration's
stated optimizer, takes the weights and batches the benchmark draws from
the seed, and runs with TF32 off (:func:`exact`), so a float32 product is
a float32 product.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact():
    """TF32 off for matrix products and convolutions, restored after."""
    kept = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = kept[:2]
        torch.set_float32_matmul_precision(kept[2])
