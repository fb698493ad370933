"""The port's Llama worker through the operator, end to end on the CPU.

Twins of ``tests/test_e2e.py``'s ``test_llama_fsdp_mesh_through_operator``
and ``test_elastic_rescale_end_to_end``: the same manifest
(``examples/llama.yaml``), loaded and changed in memory only, with the
container command set to the port's worker on the CPU. They assert what the
JAX versions assert. Slow tier, as their originals are.
"""

import os
import sys

import pytest

from mpi_operator_tpu.opshell.runlocal import load_job, run_job

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_e2e import (  # noqa: E402
    EXAMPLES,
    REPO,
    _last_report,
    _run_elastic_rescale,
    _succeeded,
)

pytestmark = pytest.mark.slow

COMMAND = ["python", "-m", "mpi_operator_tpu_torch.workers.llama_worker", "--device", "cpu"]


def test_torch_llama_fsdp_mesh_through_operator():
    job = load_job(os.path.join(EXAMPLES, "llama.yaml"))
    job.metadata.name = "torch-llama-fsdp"
    job.spec.worker.replicas = 2
    job.spec.worker.template.container.command = list(COMMAND)
    env = job.spec.worker.template.container.env
    env.pop("LLAMA_CKPT", None)  # plain loop; elasticity tested below
    env["LLAMA_MESH"] = "fsdp=2"
    env["LLAMA_STEPS"] = "4"
    env["LLAMA_SEQ"] = "32"
    final, logs = run_job(job, timeout=240, workdir=REPO)
    assert _succeeded(final), final.status.conditions
    report = _last_report(logs["default/torch-llama-fsdp-worker-0"][0])
    assert report["outcome"] == "done" and report["hosts"] == 2
    assert report["mesh"] == "fsdp=2"


def test_torch_elastic_rescale_end_to_end(tmp_path, monkeypatch):
    from mpi_operator_tpu.opshell import runlocal

    real_load = runlocal.load_job

    def load_torch_job(path):
        job = real_load(path)
        job.spec.worker.template.container.command = list(COMMAND)
        return job

    monkeypatch.setitem(_run_elastic_rescale.__globals__, "load_job", load_torch_job)
    final, report, _, ckpt = _run_elastic_rescale(
        tmp_path, name="torch-llama", from_replicas=3, to_replicas=2
    )
    assert final.status.restart_count >= 1
    assert report["hosts"] == 2 and report["step"] == 120
    saved_steps = sorted(int(p.name) for p in ckpt.iterdir() if p.is_dir())
    assert saved_steps and saved_steps[0] < 120
