"""Hygiene and entry points of the PyTorch port.

- The port and ``chip_smoke.py`` import nothing of JAX, optax, orbax or the
  JAX package (an AST scan, so a lazy import inside a function counts too).
- Its entry points run on CUDA unless the caller asks for the CPU: without
  a card they raise; they never fall back to the CPU.
- A gang without a coordinator address, a plan that cannot split the model
  and a DCN spec without a mesh are refused before any rendezvous.
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
    scanned = {os.path.relpath(p, os.path.join(REPO, "mpi_operator_tpu_torch")) for p in sources}
    assert {"ops/profiling.py", "runtime/compile_cache.py", "parallel/moe.py",
            "parallel/pipeline.py", "kernels/quant_matmul.py", "models/resnet.py",
            "models/mnist.py", "models/__init__.py", "ops/data.py", "entry.py",
            "workers/host.py", "workers/resnet_worker.py", "workers/mnist_worker.py",
            "workers/mnist_allreduce_worker.py", "workers/pi_worker.py"} <= scanned
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


def test_initialize_refuses_a_gang_without_coordinator():
    for env in ({bootstrap.ENV_NUM_HOSTS: "2"}, {bootstrap.ENV_CHIPS_PER_HOST: "2"}):
        with pytest.raises(RuntimeError, match="TPUJOB_COORDINATOR_ADDRESS is unset"):
            bootstrap.initialize(bootstrap.context_from_env(env), device="cpu")
    assert not torch.distributed.is_initialized()


def test_bench_and_worker_refuse_to_run_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.bench_llama()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_worker.main(environ={"LLAMA_STEPS": "1"})
    with pytest.raises(RuntimeError, match="does not run on the CPU"):
        bench.bench_llama(device="cpu")
    for run in (bench.bench_resnet, bench.bench_llama_longctx):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    with pytest.raises(RuntimeError, match="does not run on the CPU"):
        bench.bench_resnet(device="cpu")
    from mpi_operator_tpu_torch import entry

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()


def test_bench_main_takes_the_jax_benchs_modes(monkeypatch):
    """``BENCH_MODEL`` picks llama | llama-long | resnet | all (the JAX bench's
    order, ResNet last); the control plane's mode is not offered."""
    ran = []
    for name in ("bench_llama", "bench_llama_longctx", "bench_resnet"):
        monkeypatch.setattr(bench, name, lambda name=name: ran.append(name))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    for mode, want in (("llama", ["bench_llama"]), ("resnet", ["bench_resnet"]),
                       ("llama-long", ["bench_llama_longctx"]),
                       ("all", ["bench_llama", "bench_llama_longctx", "bench_resnet"])):
        ran.clear()
        monkeypatch.setenv("BENCH_MODEL", mode)
        bench.main()
        assert ran == want, mode
    monkeypatch.setenv("BENCH_MODEL", "controlplane")
    with pytest.raises(SystemExit, match="unknown BENCH_MODEL"):
        bench.main()


def test_entry_is_the_jax_entrys_model_on_the_cpu_when_asked():
    import __graft_entry__

    from mpi_operator_tpu_torch import entry

    fn, (model, tokens) = entry.entry(device="cpu")
    jfn, (params, jtokens) = __graft_entry__.entry()
    assert tuple(tokens.shape) == jtokens.shape and model.config.head_dim == 32
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.size(x) for x in __import__("jax").tree.leaves(params))
    with torch.no_grad():
        logits = fn(model, tokens)
    assert logits.shape == (2, 128, 2048) and bool(torch.isfinite(logits).all())


def test_bench_module_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the module would run the benchmark")
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("axis, slice_name", [
    ("tensor", "tensor-parallel"), ("sequence", "ring-attention"), ("expert", "MoE"),
    ("pipe", "pipeline"),
])
def test_worker_refuses_unported_mesh_axes(axis, slice_name):
    """No mesh axis is refused any more: ``tensor`` and ``sequence`` came
    with the tensor-parallel and ring-attention slices, ``expert`` and
    ``pipe`` run as replicas of the Llama step (the MoE and pipeline slice).
    The plan passes the port's checks and meets the gang's size instead
    (one rank here, four wanted); heads or a sequence that ``tensor`` or
    ``sequence`` does not divide raise ``ValueError`` before any
    rendezvous, also beside a replica axis."""
    with pytest.raises(ValueError, match="mesh plan wants 4 devices"):
        llama_worker.main(device="cpu", environ={"LLAMA_MESH": f"fsdp=2,{axis}=2"})
    assert not torch.distributed.is_initialized()
    # tiny() has 4 q heads and 2 kv heads; LLAMA_SEQ defaults to 64
    bad = {"tensor": ("tensor=4", "tensor=4 does not divide"),
           "sequence": ("sequence=3", "LLAMA_SEQ=64 does not split over sequence=3"),
           "expert": ("expert=2,tensor=4", "tensor=4 does not divide"),
           "pipe": ("pipe=2,sequence=3", "LLAMA_SEQ=64 does not split over sequence=3")}[axis]
    with pytest.raises(ValueError, match=bad[1]):
        llama_worker.main(device="cpu", environ={"LLAMA_MESH": bad[0]})
    assert not torch.distributed.is_initialized()
    assert not torch.distributed.is_initialized()


def test_worker_refuses_dcn_without_mesh():
    with pytest.raises(SystemExit, match="LLAMA_MESH_DCN requires LLAMA_MESH"):
        llama_worker.main(device="cpu", environ={"LLAMA_MESH_DCN": "data=2"})


def test_worker_trains_tiny_on_the_cpu_when_asked(capsys):
    record = llama_worker.main(device="cpu", environ={"LLAMA_STEPS": "3",
                                                      "LLAMA_PROGRESS_EVERY": "2"})
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "progress: batch 2"
    line = json.loads(out[-1])
    assert line == record
    assert line["workload"] == "llama" and line["outcome"] == "done" and line["step"] == 3
    assert line["backend"] == "cpu" and math.isfinite(line["loss"])


def test_worker_times_its_steps_and_profiles_the_last_ones_when_asked(tmp_path):
    """profile_llama's gang reading drives the worker through its ``on_step``
    hook: steps 2-3 timed, 4-5 profiled, one record per rank."""
    from mpi_operator_tpu_torch import profile_llama

    got = profile_llama.gang(1, {"LLAMA_STEPS": "6"}, str(tmp_path), device="cpu",
                             timeout=300)
    (rec,) = got["ranks"]
    assert rec == json.loads((tmp_path / "rank0.json").read_text())
    assert rec["rank"] == 0 and rec["timed_steps"] == 2 and rec["step_ms"] > 0
    assert len(rec["losses"]) == 6 and "kernel_launches" in rec and rec["mesh"] == ""
    assert rec["device_step_ms"] is None  # no CUDA events on the CPU
    prof = rec["profiled"]
    assert prof["steps"] == 2 and prof["wall_ms_per_step"] > 0 and prof["top_host_ops_ms_per_step"]
    assert prof["device_idle_share"] is None  # the CPU run has no device kernels
    with pytest.raises(ValueError, match="more than 4 steps"):
        profile_llama._RankProbe(torch.device("cpu"), 4)


def test_gang_reading_runs_every_rank_of_a_mesh(tmp_path):
    from mpi_operator_tpu_torch import profile_llama

    env = {"LLAMA_STEPS": "5", "LLAMA_MESH": "sequence=2", "LLAMA_SEQ": "32"}
    ranks = profile_llama.gang(2, env, str(tmp_path), device="cpu", timeout=300)["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["mesh"] == "sequence=2" and r["timed_steps"] == 1 for r in ranks)
    assert ranks[0]["losses"] == ranks[1]["losses"]  # the reported loss is the mean


def _sleep(local_rank, seconds):
    import time

    time.sleep(seconds)


def test_local_ranks_report_each_exit_code_and_end_at_the_timeout():
    import time

    assert bootstrap.run_local_ranks(sys.exit, 3) == [0, 1, 2]
    t0 = time.monotonic()
    codes = bootstrap.run_local_ranks(_sleep, 1, (60,), timeout=2)
    assert codes == [-9] and time.monotonic() - t0 < 30


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
    # host 1 of 2 draws the JAX package's host 1 rows: seed + host, half the batch
    host1 = next(data.synthetic_tokens(**{**kw, "global_batch": 6}, process_index=1,
                                       process_count=2))["tokens"]
    want = np.random.default_rng(5 + 1).integers(0, 1000, (3, 17)).astype(np.int32)
    np.testing.assert_array_equal(host1, want)


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
