"""PyTorch + CUDA port of the ``mpi_operator_tpu`` training workload.

The JAX package stays the reference; this package runs the same Llama
training step on an NVIDIA Hopper card, with the flash-attention kernels
written by hand in CUDA C++ (``kernels/csrc``). It imports nothing of the
JAX package: what it needs from there it keeps as its own copy, under the
same module names (``runtime``, ``kernels``, ``parallel``, ``models``,
``ops``) so each counterpart is easy to find.
"""
