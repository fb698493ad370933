"""The operator path driving the port's worker on a CUDA card: the twin of
``tests_tpu/test_operator_on_tpu.py``.

``examples/llama.yaml``, changed in memory only (as tests/test_torch_e2e.py
does): one replica, the port's worker with no ``--device`` (so CUDA), no
checkpoint dir, ``LLAMA_CONFIG=tiny`` (head_dim 16, as it is),
``LLAMA_STEPS=3``, ``LLAMA_SEQ=128``, run through the controller, the gang
scheduler and the local executor (``run_job``). The job succeeds, and the
worker's record shows it trained on the card through the kernels. Skips
without a card; imports no JAX, so on the card's machine:

    python -m pytest --noconftest tests/test_torch_operator_cuda.py -q
"""

import json
import os

import pytest
import torch

from mpi_operator_tpu.api.conditions import is_succeeded
from mpi_operator_tpu.opshell.runlocal import load_job, run_job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_llama_job_trains_on_a_cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the worker runs the kernels, which have no CPU mode")
    job = load_job(os.path.join(REPO, "examples", "llama.yaml"))
    job.metadata.name = "llama-cuda"
    job.spec.worker.replicas = 1
    job.spec.worker.template.container.command = [
        "python", "-m", "mpi_operator_tpu_torch.workers.llama_worker"]
    env = job.spec.worker.template.container.env
    env.pop("LLAMA_CKPT", None)
    env["LLAMA_CONFIG"] = "tiny"
    env["LLAMA_STEPS"] = "3"
    env["LLAMA_SEQ"] = "128"
    final, logs = run_job(job, timeout=300, workdir=REPO)
    out, err = logs["default/llama-cuda-worker-0"]
    assert is_succeeded(final.status), (final.status.conditions, err[-3000:])
    report = json.loads(out.strip().splitlines()[-1])
    assert report["outcome"] == "done" and report["step"] == 3
    # the worker ran on the card, through K1–K3
    assert report["backend"] == "cuda"
    assert all(report["kernel_launches"][k] > 0
               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
