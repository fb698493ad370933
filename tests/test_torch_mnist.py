"""The port's MNIST model against the JAX package's, and the image and
collective-verb workers.

- ``models/mnist.py`` on the JAX init tree (``params_from_jax``) and the
  same numpy images: logits within 1e-5 of max in f32, 3e-2 in bf16;
  ``flops_per_sample`` equal; one AdamW step's loss within 1e-5 (f32);
- each worker on the CPU in this process (one rank, explicitly
  ``device="cpu"``): ``resnet_worker`` at the manifest's tiny config,
  ``mnist_worker``, ``mnist_allreduce_worker`` and ``pi_worker``;
- slow tier, as tests/test_e2e.py's originals: the manifests
  ``examples/resnet.yaml``, ``mnist.yaml``, ``mnist_allreduce.yaml`` and
  ``pi.yaml`` through the operator (``run_job``), two hosts on gloo, the
  container command changed in memory to the port's worker on the CPU.
  π's estimate is held within 5 standard errors of π (the JAX worker's
  threefry draws are not reproducible here).
"""

import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import mnist as jmnist
from mpi_operator_tpu_torch.models import mnist as tmnist
from mpi_operator_tpu_torch.workers import (
    mnist_allreduce_worker,
    mnist_worker,
    pi_worker,
    resnet_worker,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RESNET_ENV = {"RESNET_DEPTH": "resnet26", "RESNET_BATCH": "4", "RESNET_STEPS": "3",
              "RESNET_IMAGE": "64", "RESNET_CLASSES": "10"}


def _images(seed=0, n=6):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, 28, 28, 1)).astype(np.float32),
            "label": rng.integers(0, 10, (n,)).astype(np.int32)}


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_logits_match_jax(dtype, tol):
    jc = jmnist.Config(compute_dtype=getattr(jnp, dtype))
    tc = tmnist.Config(compute_dtype=getattr(torch, dtype))
    tree = jax.tree.map(np.asarray, jmnist.init(jc, jax.random.PRNGKey(0)))
    batch = _images()
    want = np.asarray(jmnist.apply(jc, tree, jnp.asarray(batch["image"])))
    model = tmnist.MNIST(tc, device="cpu")
    model.load_state_dict(tmnist.params_from_jax(tree))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["image"])).numpy()
    assert got.shape == want.shape == (6, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


def test_one_adamw_step_matches_jax():
    from mpi_operator_tpu.ops import Trainer as JaxTrainer
    from mpi_operator_tpu.ops import TrainerConfig as JaxTrainerConfig
    from mpi_operator_tpu.ops.data import make_global_batch as jax_batch
    from mpi_operator_tpu.runtime import MeshPlan, build_mesh
    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.data import make_global_batch

    jc = jmnist.Config(compute_dtype=jnp.float32)
    tc = tmnist.Config(compute_dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jmnist.init(jc, jax.random.PRNGKey(0)))
    mesh = build_mesh(MeshPlan.data_parallel(1), jax.devices()[:1])
    jtr = JaxTrainer(lambda p, b: jmnist.loss_fn(jc, p, b), jmnist.logical_axes(jc), mesh,
                     JaxTrainerConfig(learning_rate=1e-3))
    js = jtr.init_state(jax.tree.map(jnp.asarray, tree))
    model = tmnist.MNIST(tc, device="cpu")
    model.load_state_dict(tmnist.params_from_jax(tree))
    ttr = Trainer(tmnist.loss_fn, TrainerConfig(learning_rate=1e-3))
    ts = ttr.init_state(model)
    batch = _images(1, 8)
    for _ in range(2):
        js, jm = jtr.train_step(js, jax_batch(mesh, batch))
        ts, tm = ttr.train_step(ts, make_global_batch(batch, "cpu"))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)


def test_flops_and_axes_are_the_jax_models():
    for kw in ({}, {"hidden": 32, "image_size": 32}):
        assert tmnist.flops_per_sample(tmnist.Config(**kw)) == \
            jmnist.flops_per_sample(jmnist.Config(**kw))
    theirs = jmnist.logical_axes(jmnist.Config())
    ours = tmnist.logical_axes(tmnist.Config())
    assert ours["dense1_w"] == theirs["dense1"]["w"] and ours["dense2_b"] == theirs["dense2"]["b"]
    assert ours["conv1"] == ("conv_out", "conv_in", "conv_kernel", "conv_kernel")
    model = tmnist.init(tmnist.Config(), torch.Generator().manual_seed(0), "cpu")
    assert set(ours) == {n for n, _ in model.named_parameters()}
    fields = [f.name for f in dataclasses.fields(jmnist.Config()) if f.name != "compute_dtype"]
    assert {f: getattr(tmnist.Config(), f) for f in fields} == \
        {f: getattr(jmnist.Config(), f) for f in fields}


def test_resnet_worker_trains_on_the_cpu_when_asked():
    rec = resnet_worker.main(device="cpu", environ=RESNET_ENV)
    assert rec["model"] == "resnet26" and rec["backend"] == "cpu" and rec["chips"] == 1
    assert rec["images_per_sec"] > 0 and math.isfinite(rec["loss"])


def test_mnist_workers_train_on_the_cpu_when_asked(capsys):
    rec = mnist_worker.main(5, device="cpu", environ={})
    assert rec["last_loss"] < rec["first_loss"] and rec["backend"] == "cpu"
    assert "mnist: loss" in capsys.readouterr().out
    rec = mnist_allreduce_worker.main(device="cpu", environ={"MNIST_AR_STEPS": "5"})
    assert rec["workload"] == "mnist_allreduce" and rec["last_loss"] < rec["first_loss"]


def test_pi_worker_estimates_pi(capsys):
    n = 200_000
    pi = pi_worker.main(n, device="cpu", environ={})
    # the estimate's standard error is 4·sqrt(p(1-p)/n), p = π/4
    p = math.pi / 4
    assert abs(pi - math.pi) <= 5 * 4 * math.sqrt(p * (1 - p) / n)
    assert "pi is approximately 3.1" in capsys.readouterr().out


def test_workers_refuse_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: resnet_worker.main(environ=RESNET_ENV),
                lambda: mnist_worker.main(1, environ={}),
                lambda: mnist_allreduce_worker.main(environ={}),
                lambda: pi_worker.main(10, environ={})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()


# ---------- through the operator: twins of tests/test_e2e.py (slow tier) ----------


def _torch_job(manifest, module, args=()):
    from test_e2e import EXAMPLES

    from mpi_operator_tpu.opshell.runlocal import load_job

    job = load_job(os.path.join(EXAMPLES, manifest))
    job.metadata.name = "torch-" + job.metadata.name
    job.spec.worker.template.container.args = []
    job.spec.worker.template.container.command = [
        "python", "-m", f"mpi_operator_tpu_torch.workers.{module}", *args, "--device", "cpu"]
    return job


@pytest.mark.slow
def test_torch_resnet_example_end_to_end():
    from test_e2e import REPO, _last_report, _succeeded

    from mpi_operator_tpu.opshell.runlocal import run_job

    final, logs = run_job(_torch_job("resnet.yaml", "resnet_worker"), timeout=360, workdir=REPO)
    assert _succeeded(final), final.status.conditions
    report = _last_report(logs["default/torch-resnet-worker-0"][0])
    assert report["hosts"] == 2 and report["images_per_sec"] > 0
    w1 = logs.get("default/torch-resnet-worker-1")
    assert w1 is None or "images_per_sec" not in w1[0]


@pytest.mark.slow
def test_torch_mnist_example_end_to_end():
    from test_e2e import REPO, _succeeded

    from mpi_operator_tpu.opshell.runlocal import run_job

    final, logs = run_job(_torch_job("mnist.yaml", "mnist_worker", ("20",)), timeout=240,
                          workdir=REPO)
    assert _succeeded(final), final.status.conditions
    out = logs["default/torch-mnist-worker-0"][0]
    assert "loss" in out and "2 hosts" in out


@pytest.mark.slow
def test_torch_mnist_allreduce_example_end_to_end():
    from test_e2e import REPO, _last_report, _succeeded

    from mpi_operator_tpu.opshell.runlocal import run_job

    final, logs = run_job(_torch_job("mnist_allreduce.yaml", "mnist_allreduce_worker"),
                          timeout=240, workdir=REPO)
    assert _succeeded(final), final.status.conditions
    report = _last_report(logs["default/torch-mnist-allreduce-worker-0"][0])
    assert report["hosts"] == 2 and report["last_loss"] < report["first_loss"]


@pytest.mark.slow
def test_torch_pi_example_end_to_end():
    from test_e2e import REPO, _succeeded

    from mpi_operator_tpu.opshell.runlocal import run_job

    final, logs = run_job(_torch_job("pi.yaml", "pi_worker", ("50000",)), timeout=180,
                          workdir=REPO)
    assert _succeeded(final), final.status.conditions
    out = logs["default/torch-pi-worker-0"][0]
    pi = float(out.split("pi is approximately ")[1].split()[0])
    p = math.pi / 4
    assert abs(pi - math.pi) <= 5 * 4 * math.sqrt(p * (1 - p) / (2 * 50_000))
    assert "pi is approximately" not in logs["default/torch-pi-worker-1"][0]
