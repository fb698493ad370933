"""The benchmark of the PyTorch and CUDA port (``mpi_operator_tpu_torch``):
``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
"""
