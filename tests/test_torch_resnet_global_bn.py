"""Global batch norm: the port's ResNet on two gloo ranks against its
one-device run and the JAX package's global batch norm.

``data=2`` and ``fsdp=2`` over two gloo ranks (tests/test_torch_sharded_step.py's
``run_ranks``), three momentum steps of tests/test_torch_resnet.py's
resnet26 on the synthetic stream's batch: the batch-norm statistics are
all-reduced over the batch ranks, so the two ranks compute the one-device
step: losses and statistics within 5e-5 of the port's one-device run
(1.3e-5 and 1.2e-5 measured: the all-reduce sums partial sums in another
order), and the losses within tests/test_torch_resnet.py's step bounds of
JAX's global batch norm on two CPU devices (the first within 1e-5).
Per-rank statistics would differ from both.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_resnet import (  # noqa: E402
    FIELDS,
    STEPS,
    TOL_STEPS,
    _close,
    _configs,
    _jax_init,
    _jax_steps,
    _port_steps,
    _stream_batch,
)
from test_torch_sharded_step import gang, run_ranks  # noqa: E402

from mpi_operator_tpu_torch.models import resnet as tresnet  # noqa: E402


def _rank(local_rank, args):
    import torch.distributed as dist

    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.data import make_global_batch
    from mpi_operator_tpu_torch.runtime import bootstrap

    mesh = gang(local_rank, args["plan"])
    model = tresnet.ResNet(_configs()[1], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in np.load(args["weights"]).items()})
    trainer = Trainer(tresnet.loss_fn, TrainerConfig(**FIELDS), mesh=mesh)
    st = trainer.init_state(model)
    losses = []
    for step in range(STEPS):
        st, m = trainer.train_step(st, make_global_batch(_stream_batch(), "cpu", mesh))
        losses.append(m["loss"].item())
    if dist.get_rank() == 0:
        print(json.dumps({"losses": losses,
                          "stats": {n: b.tolist() for n, b in st.model_state.items()}}))
    bootstrap.shutdown()


@pytest.mark.parametrize("plan", ["data=2", "fsdp=2"])
def test_global_batch_norm_on_two_ranks_matches_jax(plan, tmp_path):
    params, state = _jax_init()
    weights = tmp_path / "w.npz"
    np.savez(weights, **{k: v.numpy() for k, v in tresnet.params_from_jax(params, state).items()})
    got = run_ranks(__file__, 2, {"plan": plan, "weights": str(weights)})
    stats = {n: np.asarray(v, np.float32) for n, v in got["stats"].items()}
    one_losses, one_stats, _ = _port_steps(params, state)
    np.testing.assert_allclose(got["losses"], one_losses, rtol=5e-5)
    _close(stats, one_stats, 5e-5)
    want_losses, _, _ = _jax_steps(params, state, plan)
    np.testing.assert_allclose(got["losses"][0], want_losses[0], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=TOL_STEPS)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
