"""The harness finds a new configuration, mix, cell and metric by name, from
new files alone; its result line has the contract's keys; and the command
refuses to run without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import harness, spec

import tiny

METRIC = '''"""Train steps the window completed: a test's metric."""


def read(run):
    return float(run.steps)
'''

RUN = textwrap.dedent("""
    import json, sys, time
    sys.path[:0] = [".", {repo!r}]
    import torch
    from benchmark import harness
    for trace in (False, True):
        out, _ = harness.execute({cell!r}, 2 ** 33 + 5, 0.2, trace, torch.device("cpu"),
                                 time.perf_counter(), ".")
        print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with the tiny cells and one more metric, all
    added as files and entries: no file of the copy is edited."""
    root = tiny.make_root(str(tmp_path_factory.mktemp("bench")))
    with open(os.path.join(root, "benchmark", "metrics", "window_steps.tiny.py"), "w") as f:
        f.write(METRIC)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "window_steps.tiny", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "ops/trainer (whole step)",
                               "moves": "tokens_per_s_per_gpu",
                               "workloads": ["tiny-decoder.t48"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def test_new_files_are_found_by_name(root):
    cell = spec.load_cell("tiny-decoder.t48", root)
    assert cell.config["hidden_size"] == 64 and cell.traffic["seq_len"] == 48
    assert "window_steps.tiny" in [m["name"] for m in cell.per_layer]
    assert [m["name"] for m in spec.load_cell("tiny-resnet.b16", root).per_layer] == [
        "input_wait_ms.resnet", "mfu.resnet", "elementwise_ms.resnet", "idle_share.resnet"]


def test_result_lines(root):
    """The copy runs in its own process, from its own files."""
    proc = subprocess.run([sys.executable, "-c", RUN.format(repo=tiny.ROOT,
                                                            cell="tiny-decoder.t48")],
                          cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced = (json.loads(line) for line in proc.stdout.strip().splitlines()[-2:])
    required = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(plain) == required + ["checks"]
    assert list(traced) == required + ["breakdown", "checks"]
    assert plain["correct"] and traced["correct"]
    # off the card: no peak memory, and no device metric is read from the CPU
    assert set(plain["metrics"]) == {"tokens_per_s_per_gpu", "setup_s"}
    assert set(traced["metrics"]) == {"window_steps.tiny"}
    assert traced["metrics"]["window_steps.tiny"] == {"value": traced["attempted"],
                                                      "unit": "steps"}
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in traced["checks"].values():
        assert set(c) == {"value", "limit", "leaf"}


def test_gang_result_lines(root):
    """A cell on four ranks (gloo, one process each) gives one line with the
    gang's readings: every rank ran the window's steps, and the line holds
    the worst rank's."""
    import time

    for trace in (False, True):
        out, extra = harness.execute_ranks(tiny.GANG, 2 ** 33 + 5, 0.2, trace,
                                           time.perf_counter(), root, device_type="cpu")
        assert out["correct"], out["checks"]
        assert out["device"]["count"] == 4 and out["attempted"] >= 1
        assert set(extra["seconds"]) == {"start", "built", "first_steps", "reference"}
        assert extra["forbidden"] == []
        if trace:
            assert list(out) == ["correct", "attempted", "failed", "metrics", "device",
                                 "breakdown", "checks"]
        else:
            assert set(out["metrics"]) == {"tokens_per_s_per_gpu.fsdp", "setup_s"}
            rate = out["metrics"]["tokens_per_s_per_gpu.fsdp"]["value"]
            assert 0 < rate and out["metrics"]["setup_s"]["value"] > 0


def _command(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "mistral-7b-l8.s4096", "--seed", str(2 ** 31 + 9), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    proc = _command(tiny.ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA card" in proc.stderr


def test_bare_checkout_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    has no program to run."""
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    proc = _command(str(tmp_path), env={k: v for k, v in os.environ.items()
                                        if k != "PYTHONPATH"})
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_modules_are_named_by_whole_top_level_names():
    mods = ["jax.numpy", "mpi_operator_tpu_torch.ops", "mpi_operator_tpu.models", "flaxen"]
    assert harness.forbidden_modules(mods) == ["jax", "mpi_operator_tpu"]
