"""The port's profiler hooks (``ops/profiling.py``) against the JAX
package's (``mpi_operator_tpu/ops/profiling.py``).

- The request watcher's state machine: one sequence of projected request
  files (a new id; the same id again, also as a number; a relaunched
  worker finding its capture on the shared volume; a profiler that raises
  on start; ``close`` in the middle of a capture) gives the same acks, in
  the same order, in the step-stats blob of either package.
- The torch backend on the CPU: a capture is a Chrome trace of CPU
  activity in ``<dir>/host0``; the env's step window (``StepProfiler``)
  traces only its steps; the elastic loop polls a request at its
  membership check and acks ``done`` with a trace on disk.
"""

import json
import os

import torch

from mpi_operator_tpu.ops import profiling as jprofiling
from mpi_operator_tpu.runtime import stepstats as jstepstats
from mpi_operator_tpu_torch.ops import profiling
from mpi_operator_tpu_torch.runtime import stepstats


def _request(cfg, **req):
    with open(os.path.join(cfg, "profile"), "w") as f:
        json.dump(req, f)


def _scenario(watcher_cls, recorder_cls, root):
    """Drive a watcher through the request sequence; returns the blob's
    ``profile`` entry after every ack (dirs relative to the out root) and
    the traces started and stopped."""
    cfg, out = os.path.join(root, "cfg"), os.path.join(root, "out")
    os.makedirs(cfg)
    blob = os.path.join(root, "stats.json")
    stats = recorder_cls(blob, interval=0.0)
    acks, calls = [], []
    real_set = stats.set_profile

    def set_profile(req_id, state, directory):
        real_set(req_id, state, directory)
        entry = dict(json.load(open(blob))["profile"])
        entry["dir"] = os.path.relpath(entry["dir"], out)
        acks.append(entry)

    stats.set_profile = set_profile
    fail = {"start": False}

    def start(directory):
        if fail["start"]:
            raise RuntimeError("no profiler in this build")
        calls.append(("start", os.path.relpath(directory, out)))
        with open(os.path.join(directory, "trace.json"), "w") as f:
            f.write("{}")  # what a real capture leaves behind

    def stop():
        calls.append(("stop",))

    def watcher():
        return watcher_cls(stats, config_dir=cfg, out_root=out, host_index=0,
                           start_trace=start, stop_trace=stop)

    w = watcher()
    w.poll(2)  # no request file yet
    _request(cfg, id="r1", steps=2)
    w.poll(10)
    w.observe(11)
    w.observe(12)  # the window has passed: done
    w.poll(14)  # the same id again: nothing
    _request(cfg, id=7, steps=1)
    w.poll(16)
    w.observe(17)
    _request(cfg, id="7", steps=1)  # the numeric id, now a string: not new
    w.poll(18)
    w = watcher()  # a relaunched worker re-reads the old request
    w.poll(20)  # its capture is on the shared volume: done, no start
    fail["start"] = True
    _request(cfg, id="boom", steps=1)
    w.poll(22)
    fail["start"] = False
    _request(cfg, id="r9", steps=5)
    w.poll(30)
    w.observe(31)
    w.close()  # mid-capture: stops and acks done
    return acks, calls


def test_request_watcher_acks_are_the_jax_watchers(tmp_path):
    ours = _scenario(profiling.ProfileRequestWatcher, stepstats.StepStatsRecorder,
                     str(tmp_path / "port"))
    theirs = _scenario(jprofiling.ProfileRequestWatcher, jstepstats.StepStatsRecorder,
                       str(tmp_path / "jax"))
    assert ours == theirs
    acks, calls = ours
    assert [(a["id"], a["state"]) for a in acks] == [
        ("r1", "capturing"), ("r1", "done"), ("7", "capturing"), ("7", "done"), ("7", "done"),
        ("boom", "failed"), ("r9", "capturing"), ("r9", "done")]
    assert all(a["dir"] == os.path.join(a["id"], "host0") for a in acks)
    assert calls == [("start", "r1/host0"), ("stop",), ("start", "7/host0"), ("stop",),
                     ("start", "r9/host0"), ("stop",)]
    assert profiling.PROFILE_REQUEST_FILE == jprofiling.PROFILE_REQUEST_FILE
    assert (profiling.ENV_DIR, profiling.ENV_START, profiling.ENV_STEPS) == \
        (jprofiling.ENV_DIR, jprofiling.ENV_START, jprofiling.ENV_STEPS)


def _trace_names(path):
    with open(path) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


def test_torch_trace_on_the_cpu_is_a_chrome_trace_of_cpu_ops(tmp_path):
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    _request(str(cfg), id="cpu", steps=2)
    stats = stepstats.StepStatsRecorder(str(tmp_path / "s.json"), interval=0.0)
    w = profiling.ProfileRequestWatcher(stats, config_dir=str(cfg), out_root=str(tmp_path / "p"))
    x = torch.ones(8, 8)
    w.poll(0)
    for step in range(1, 4):
        x = x @ x / 8
        w.observe(step)
    blob = stepstats.read_stats(str(tmp_path / "s.json"))
    assert blob["profile"] == {"id": "cpu", "state": "done", "dir": str(tmp_path / "p/cpu/host0")}
    assert "aten::mm" in _trace_names(tmp_path / "p/cpu/host0" / profiling.TRACE_FILE)


def test_step_profiler_traces_its_window(tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.ENV_DIR, str(tmp_path))
    monkeypatch.setenv(profiling.ENV_START, "2")
    monkeypatch.setenv(profiling.ENV_STEPS, "2")
    prof = profiling.StepProfiler()
    x = torch.ones(4, 4)
    for step in range(1, 7):
        prof.observe(step)
        x = (x @ x) if step in (2, 3) else x + 1
    prof.close()
    names = _trace_names(tmp_path / "host0" / profiling.TRACE_FILE)
    assert "aten::mm" in names and "aten::add" not in names
    assert not profiling.StepProfiler(directory="").enabled


def test_elastic_loop_serves_a_profile_request(tmp_path, monkeypatch):
    import dataclasses

    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
    from mpi_operator_tpu_torch.ops.elastic import ElasticConfig, run_elastic

    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    _request(str(cfg_dir), id="req", steps=2)
    monkeypatch.setenv("TPUJOB_CONFIG_DIR", str(cfg_dir))
    monkeypatch.setenv(stepstats.ENV_STATS_FILE, str(tmp_path / "stats.json"))
    monkeypatch.setenv(stepstats.ENV_STATS_INTERVAL, "0")
    cfg = dataclasses.replace(llama.tiny(), n_layers=1)
    trainer = Trainer(llama.loss_fn, TrainerConfig(learning_rate=1e-2))
    batches = (make_global_batch(b, "cpu")
               for b in synthetic_tokens(global_batch=2, seq_len=16, vocab=cfg.vocab))
    res = run_elastic(
        trainer, batches, total_steps=6,
        config=ElasticConfig(checkpoint_dir=str(tmp_path / "ckpt"), save_interval_steps=6,
                             membership_check_every=2),
        init_state=lambda: trainer.init_state(
            llama.init(cfg, torch.Generator().manual_seed(0), "cpu")),
        membership=lambda: 1, current_world=1,
    )
    assert res.outcome == "done"
    trace_dir = tmp_path / "ckpt" / "profiles" / "req" / "host0"
    blob = stepstats.read_stats(str(tmp_path / "stats.json"))
    assert blob["profile"] == {"id": "req", "state": "done", "dir": str(trace_dir)}
    assert "aten::mm" in _trace_names(trace_dir / profiling.TRACE_FILE)
