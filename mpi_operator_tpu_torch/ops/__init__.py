"""Training step and input data."""

from mpi_operator_tpu_torch.ops.trainer import Trainer, TrainerConfig, TrainState
