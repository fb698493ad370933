"""The port's train step on meshes with a ``sequence`` axis (the ring) against
the JAX package's ``Trainer`` on the same plan, with the JAX ring active;
and the worker itself on the 3-axis plan. The harness and tolerances are
tests/test_torch_tensor_parallel.py's (loss and grad norm 1e-5 relative in
f32, parameters 1e-4 in relative norm, shard dimensions the JAX
``NamedSharding``'s); this file holds the ``sequence`` plans so that the
two files run side by side under ``--dist loadfile``.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tensor_parallel import _rank, check_step_against_jax  # noqa: E402


@pytest.mark.parametrize("plan", ["sequence=2,data=2", "fsdp=2,tensor=2,sequence=2"])
def test_sequence_step_matches_jax_trainer(plan, tmp_path):
    check_step_against_jax(plan, tmp_path, script=__file__)


def _worker(env):
    import subprocess

    from test_torch_sharded_step import REPO, free_port

    base = {k: v for k, v in os.environ.items()
            if not k.startswith("LLAMA_") and k != "TPUJOB_CKPT_DIR"}
    env = dict(base, PYTHONPATH=REPO, OMP_NUM_THREADS="1", LLAMA_STEPS="2", LLAMA_SEQ="32",
               TPUJOB_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}", **env)
    proc = subprocess.run([sys.executable, "-m", "mpi_operator_tpu_torch.workers.llama_worker",
                           "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_worker_trains_tiny_on_an_fsdp_tensor_sequence_mesh():
    """The worker as the operator launches it, 8 gloo ranks on
    ``fsdp=2,tensor=2,sequence=2``, against itself on one rank with the
    same global batch (16 rows). The worker computes in bf16, so the
    losses are held at 1e-2 relative; the f32 parity with JAX is the test
    above."""
    mesh = _worker({"TPUJOB_CHIPS_PER_HOST": "8", "LLAMA_MESH": "fsdp=2,tensor=2,sequence=2"})
    alone = _worker({"TPUJOB_CHIPS_PER_HOST": "1", "LLAMA_BATCH": "16"})
    assert mesh["outcome"] == "done" and mesh["mesh"] == "fsdp=2,sequence=2,tensor=2"
    assert mesh["kernel_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    np.testing.assert_allclose(mesh["losses"], alone["losses"], rtol=1e-2)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
