"""Hygiene and entry points of the PyTorch port.

- The port and ``chip_smoke.py`` import nothing of JAX, optax, orbax or the
  JAX package (an AST scan, so a lazy import inside a function counts too).
- Its entry points run on CUDA unless the caller asks for the CPU: without
  a card they raise; they never fall back to the CPU.
- The copies it keeps of the JAX package's framework-free pieces (env
  names, context parsing, the token stream) agree with the originals.
"""

import ast
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpi_operator_tpu.ops import data as jax_data
from mpi_operator_tpu.runtime import bootstrap as jax_bootstrap
from mpi_operator_tpu_torch import bench
from mpi_operator_tpu_torch.ops import data
from mpi_operator_tpu_torch.runtime import bootstrap
from mpi_operator_tpu_torch.workers import llama_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "mpi_operator_tpu")


def _port_sources():
    root = os.path.join(REPO, "mpi_operator_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) >= 10
    bad = [
        f"{os.path.relpath(p, REPO)}: {m}"
        for p in sources for m in _imported_modules(p) if _forbidden(m)
    ]
    assert bad == []


def test_the_import_scan_catches_what_it_must():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("optax")
    assert _forbidden("mpi_operator_tpu") and _forbidden("mpi_operator_tpu.runtime.bootstrap")
    assert not _forbidden("mpi_operator_tpu_torch") and not _forbidden("jaxtyping_like")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_initialize_refuses_the_cpu_unless_asked(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bootstrap.initialize(environ={})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bootstrap.initialize(environ={bootstrap.ENV_ACCELERATOR: "cpu"})
    assert bootstrap.initialize(environ={}, device="cpu") == torch.device("cpu")


def test_initialize_refuses_multi_host():
    ctx = bootstrap.context_from_env({bootstrap.ENV_NUM_HOSTS: "2"})
    with pytest.raises(NotImplementedError, match="multi-host"):
        bootstrap.initialize(ctx, device="cpu")


def test_bench_and_worker_refuse_to_run_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.bench_llama()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_worker.main(environ={"LLAMA_STEPS": "1"})
    with pytest.raises(RuntimeError, match="does not run on the CPU"):
        bench.bench_llama(device="cpu")


def test_bench_module_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the module would run the benchmark")
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("name", ["LLAMA_CKPT", "LLAMA_MESH", "LLAMA_MESH_DCN",
                                  bootstrap.ENV_CKPT_DIR])
def test_worker_refuses_unported_options(name):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        llama_worker.main(device="cpu", environ={name: "/x", "LLAMA_STEPS": "1"})


def test_worker_trains_tiny_on_the_cpu_when_asked(capsys):
    record = llama_worker.main(device="cpu", environ={"LLAMA_STEPS": "3",
                                                      "LLAMA_PROGRESS_EVERY": "2"})
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "progress: batch 2"
    line = json.loads(out[-1])
    assert line == record
    assert line["workload"] == "llama" and line["outcome"] == "done" and line["step"] == 3
    assert line["backend"] == "cpu" and math.isfinite(line["loss"])


def test_env_names_and_context_match_the_jax_package():
    names = [n for n in dir(jax_bootstrap) if n.startswith("ENV_")]
    assert names and all(getattr(bootstrap, n) == getattr(jax_bootstrap, n) for n in names)
    env = {
        "TPUJOB_NAME": "j", "TPUJOB_NAMESPACE": "ns", "TPUJOB_COORDINATOR_ADDRESS": "h:1",
        "TPUJOB_NUM_HOSTS": "4", "TPUJOB_HOST_ID": "2", "TPUJOB_CHIPS_PER_HOST": "8",
        "TPUJOB_ACCELERATOR": "h100", "TPUJOB_TOPOLOGY": "2x4", "TPUJOB_HOST_MESH": "2x2",
        "TPUJOB_HOST_COORD": "1x0", "TPUJOB_SLICE_ID": "1", "TPUJOB_NUM_SLICES": "2",
        "TPUJOB_CKPT_DIR": "/ckpt",
    }
    ours, theirs = bootstrap.context_from_env(env), jax_bootstrap.context_from_env(env)
    fields = [f for f in vars(theirs)]
    assert {f: getattr(ours, f) for f in fields} == vars(theirs)
    assert ours.local_chips() == 8 and not ours.is_coordinator and ours.is_distributed
    assert bootstrap.default_checkpoint_dir(ours, env) == \
        jax_bootstrap.default_checkpoint_dir(theirs, env) == "/ckpt/ns/j"
    # the one deliberate difference: no accelerator declared means none, not "cpu"
    assert bootstrap.context_from_env({}).accelerator == ""


def test_synthetic_tokens_are_the_jax_stream():
    kw = dict(global_batch=3, seq_len=17, vocab=1000, seed=5)
    ours, theirs = next(data.synthetic_tokens(**kw)), next(jax_data.synthetic_tokens(**kw))
    assert ours["tokens"].dtype == theirs["tokens"].dtype == np.int32
    np.testing.assert_array_equal(ours["tokens"], theirs["tokens"])
    batch = data.make_global_batch(ours, "cpu")
    assert batch["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(batch["tokens"].numpy(), theirs["tokens"])


def test_bench_timed_steps_on_a_tiny_model_on_the_cpu():
    import dataclasses

    from mpi_operator_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.tiny(), remat_layers=True)
    _, trainer, state, batch, gb = bench.llama_setup(2, 32, config=cfg, device="cpu")
    losses = []
    state, dt, steps, setup_s, warmup_s = bench.timed_steps(
        trainer, state, batch, 3, 2, on_step=lambda m: losses.append(m["loss"].item())
    )
    assert gb == 2 and steps == 3 and state.step == 5 and len(losses) == 5
    assert dt > 0 and setup_s > 0 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]


def test_peak_flops_is_known_for_hopper_only():
    assert bench.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(ValueError):
        bench.peak_flops("cpu")
