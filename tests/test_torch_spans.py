"""The port's spans and device marks (``runtime/stepstats.py``), on the CPU,
and the benchmark's readers of them (``benchmark/marks.py``,
``benchmark/metrics/``) on synthetic traces.

- With no capture, ``span()`` is one shared null context: nothing is
  recorded and no mark launched.
- Under a CPU ``torch.profiler`` capture, a train step of the tiny Llama
  and of the tiny ResNet is ``trainer.step`` holding ``trainer.forward``,
  ``trainer.backward`` and ``trainer.optimizer`` (which holds
  ``trainer.clip`` and ``trainer.update``), each counted once a step; the
  loop's phases are ``loop.<bucket>``; ``data.batch`` and ``data.wait``
  close once a batch.
- A capture changes no number of the step: losses and parameters after 3
  steps are bitwise those of a run without one.
- The marks are read by their points; the four phases' idle adds up to the
  idle between the first mark and the last; a lost mark takes only the
  stretches it bounds; every reader reads nothing without marks or a trace.
"""

import contextlib
import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import marks, spec
from benchmark.trace import Trace
from mpi_operator_tpu_torch.kernels import _build
from mpi_operator_tpu_torch.models import llama, resnet
from mpi_operator_tpu_torch.ops import data
from mpi_operator_tpu_torch.ops.trainer import Trainer, TrainerConfig
from mpi_operator_tpu_torch.runtime import stepstats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEP_SPANS = ("trainer.step", "trainer.forward", "trainer.backward", "trainer.optimizer",
              "trainer.clip", "trainer.update")
# (span, its parent)
NESTING = (("trainer.forward", "trainer.step"), ("trainer.backward", "trainer.step"),
           ("trainer.optimizer", "trainer.step"), ("trainer.clip", "trainer.optimizer"),
           ("trainer.update", "trainer.optimizer"))


@pytest.fixture(autouse=True)
def fresh_totals():
    stepstats.reset_span_totals()
    yield
    stepstats.reset_span_totals()


def _capture():
    return profile(activities=[ProfilerActivity.CPU])


def _llama():
    model = llama.init(llama.tiny(), torch.Generator().manual_seed(0), "cpu")
    trainer = Trainer(lambda m, b: llama.loss_fn(m, b),
                      TrainerConfig(learning_rate=1e-3, grad_clip_norm=1.0))
    tokens = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)
    return trainer, trainer.init_state(model), data.make_global_batch({"tokens": tokens}, "cpu")


def _resnet():
    cfg = resnet.Config(depth="resnet26", width=8, image_size=32, num_classes=10)
    model = resnet.init(cfg, torch.Generator().manual_seed(0), "cpu")
    trainer = Trainer(resnet.loss_fn, TrainerConfig(learning_rate=1e-3, optimizer="momentum",
                                                    grad_clip_norm=1.0))
    rng = np.random.default_rng(0)
    host = {"image": rng.standard_normal((2, 32, 32, 3), np.float32),
            "label": rng.integers(0, 10, (2,)).astype(np.int32)}
    return trainer, trainer.init_state(model), data.make_global_batch(host, "cpu")


MODELS = {"llama": _llama, "resnet": _resnet}


def test_span_without_a_capture_is_the_shared_null_and_records_nothing():
    a, b = stepstats.span("trainer.step"), stepstats.span("data.wait")
    assert a is b is stepstats._NULL_SPAN
    with a:
        pass
    assert stepstats.span_totals() == {}


def test_a_cpu_trainer_takes_no_marks_and_a_mark_launches_only_in_a_capture(monkeypatch):
    trainer, _, _ = _llama()
    assert trainer._mark_device is None
    assert stepstats.load_device_marks("cpu") is False
    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(stepstats, "_mark_lib", None)
    monkeypatch.setattr(_build, "library", no_nvcc)
    assert stepstats.load_device_marks("cuda") is False  # no nvcc: no marks, no failure
    launched = []
    lib = types.SimpleNamespace(
        tpujob_span_mark_launch=lambda point, stream: launched.append((point, stream)) or 0)
    monkeypatch.setattr(stepstats, "_mark_lib", lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    for point in stepstats.MARK_POINTS:
        stepstats.device_mark(torch.device("cuda", 0), point)
    stepstats.device_mark(None, "fwd")
    assert launched == []
    with _capture():
        for point in stepstats.MARK_POINTS:
            stepstats.device_mark(torch.device("cuda", 0), point)
        stepstats.device_mark(None, "fwd")
    assert launched == [(i, 7) for i in range(len(stepstats.MARK_POINTS))]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_captured_step_nests_the_trainer_spans_and_counts_each_once(name):
    trainer, state, batch = MODELS[name]()
    steps = 2
    with _capture() as prof:
        for _ in range(steps):
            state, _ = trainer.train_step(state, batch)
    events = [e for e in prof.events() if e.name in STEP_SPANS]
    by_name = {n: [e for e in events if e.name == n] for n in STEP_SPANS}
    assert {n: len(v) for n, v in by_name.items()} == {n: steps for n in STEP_SPANS}
    for child, parent in NESTING:
        for c in by_name[child]:
            assert any(p.time_range.start <= c.time_range.start
                       and c.time_range.end <= p.time_range.end for p in by_name[parent])
    totals = stepstats.span_totals()
    assert {n: totals[n]["count"] for n in STEP_SPANS} == {n: steps for n in STEP_SPANS}
    assert all(totals[n]["seconds"] > 0 for n in STEP_SPANS)
    assert totals["trainer.step"]["seconds"] >= totals["trainer.forward"]["seconds"]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_capture_changes_no_number_of_the_step(name):
    runs = []
    for captured in (False, True):
        trainer, state, batch = MODELS[name]()
        losses = []
        with (_capture() if captured else contextlib.nullcontext()):
            for _ in range(3):
                state, m = trainer.train_step(state, batch)
                losses.append(m["loss"].clone())
        runs.append((losses, {k: v.clone() for k, v in state.params.state_dict().items()}))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert p0.keys() == p1.keys() and all(torch.equal(p0[k], p1[k]) for k in p0)
    assert stepstats.span_totals()["trainer.step"]["count"] == 3


def test_the_loop_phases_are_spans_named_by_their_bucket_and_the_blob_is_unchanged():
    def recorder():
        ticks = iter(range(100))
        return stepstats.StepStatsRecorder(clock=lambda: float(next(ticks)))

    def drive(stats):
        for bucket in ("input", "compute", "compute", "sync", "ckpt"):
            with stats.phase(bucket):
                pass
        stats.step_done(1)
        return json.dumps(stats.snapshot(), sort_keys=True)

    plain = drive(recorder())
    with _capture() as prof:
        traced = drive(recorder())
    assert traced == plain
    names = [e.name for e in prof.events() if e.name.startswith("loop.")]
    assert names == ["loop.input", "loop.compile", "loop.compute", "loop.sync", "loop.ckpt"]


def test_the_input_spans_close_once_a_batch_on_the_capturing_thread():
    host = {"tokens": np.zeros((2, 8), np.int32)}
    batches = data.prefetch(iter([host] * 3), "cpu")
    try:
        with _capture():
            got = [next(batches) for _ in range(3)]
            data.make_global_batch(host, "cpu")
    finally:
        batches.close()
    assert len(got) == 3
    totals = stepstats.span_totals()
    assert totals["data.wait"]["count"] == 3
    # the producer thread's copies record nothing; the call on this thread does
    assert totals["data.batch"]["count"] == 1


# ---------------------------------------------------------------------------
# benchmark/marks.py and the readers, on synthetic traces
# ---------------------------------------------------------------------------

# two steps, in us: each step's marks and its kernels on three streams, with
# idle in every phase and between the steps
STEP = {"fwd": 100, "bwd": 200, "opt": 410, "end": 500}
KERNELS = [("gemm_a", 105, 190), ("elementwise_b", 205, 300), ("nccl_c", 250, 280),
           ("nccl_c", 320, 420), ("adam_d", 430, 470), ("Memcpy HtoD", 520, 540)]
PHASES = ("forward", "backward", "optimizer", "input")


def _trace(steps=2, period=600, drop=0, name="tpujob_span_mark_{}"):
    """The synthetic trace of ``steps`` steps, its first ``drop`` marks lost,
    its rows in reverse order (a trace's rows come in no set order)."""
    device = []
    for i in range(steps):
        t = i * period
        device += [(name.format(p), t + s, t + s + 1) for p, s in STEP.items()]
        device += [(n, t + s, t + e) for n, s, e in KERNELS]
    lost = [r for r in device if "mark" in r[0]][:drop]
    device = [r for r in device if r not in lost]
    return Trace(device=device[::-1], host=[], wall_s=steps * period / 1e6, steps=steps)


def _idle_brute(trace, a, b):
    """Idle microseconds in [a, b), one microsecond at a time."""
    return sum(not any(s <= t < e for _, s, e in trace.device) for t in range(int(a), int(b)))


def test_marks_are_read_by_their_points_in_time_order():
    assert marks.points(_trace()) == [(p, float(s + t)) for t in (0, 600)
                                      for p, s in STEP.items()]
    assert marks.stretches(_trace(), "forward") == [(100, 200), (700, 800)]
    assert marks.stretches(_trace(), "optimizer") == [(410, 500), (1010, 1100)]
    assert marks.stretches(_trace(), "input") == [(500, 700)]


def test_the_four_phases_tile_the_idle_between_the_first_mark_and_the_last():
    tr = _trace(steps=3)
    n = {"forward": 3, "backward": 3, "optimizer": 3, "input": 2}
    total = sum(marks.idle_ms(tr, ph) * 1e3 * k for ph, k in n.items())
    assert total == pytest.approx(_idle_brute(tr, 100, 1700))
    for ph in n:
        spans = marks.stretches(tr, ph)
        assert len(spans) == n[ph]
        want = sum(_idle_brute(tr, a, b) for a, b in spans) / n[ph] / 1e3
        assert marks.idle_ms(tr, ph) == pytest.approx(want)
    assert marks.phase_ms(tr, "optimizer") == pytest.approx(0.09)
    assert marks.phase_ms(tr, "input") == pytest.approx(0.2)


def test_a_lost_mark_takes_only_the_stretches_it_bounds():
    tr = _trace(drop=1)  # the capture lost the first step's fwd mark
    assert marks.stretches(tr, "forward") == [(700, 800)]
    assert marks.stretches(tr, "backward") == [(200, 410), (800, 1010)]
    assert marks.stretches(tr, "input") == [(500, 700)]
    assert marks.idle_ms(tr, "forward") == pytest.approx(marks.idle_ms(_trace(), "forward"))
    assert marks.phase_ms(tr, "optimizer") == marks.phase_ms(_trace(), "optimizer")


@pytest.mark.parametrize("trace", [None, Trace([], [], 1.0, 2), _trace(name="tpujob_span_mark"),
                                   _trace(name="other_kernel_{}")],
                         ids=["no trace", "cpu", "unlabelled marks", "no marks"])
def test_marks_read_nothing_without_marks(trace):
    assert marks.points(trace) == []
    for ph in PHASES:
        assert marks.stretches(trace, ph) == []
        assert marks.idle_ms(trace, ph) is None and marks.phase_ms(trace, ph) is None


READERS = {  # name -> (unit, chips, what it reads from the synthetic trace)
    "optimizer_ms.decoder": ("tokens", 1, lambda tr: marks.phase_ms(tr, "optimizer")),
    "optimizer_ms.resnet": ("images", 1, lambda tr: marks.phase_ms(tr, "optimizer")),
    "optimizer_ms.fsdp": ("tokens", 4, lambda tr: marks.phase_ms(tr, "optimizer")),
    "idle_ms.forward.fsdp": ("tokens", 4, lambda tr: marks.idle_ms(tr, "forward")),
    "idle_ms.backward.fsdp": ("tokens", 4, lambda tr: marks.idle_ms(tr, "backward")),
    "idle_ms.optimizer.fsdp": ("tokens", 4, lambda tr: marks.idle_ms(tr, "optimizer")),
    "idle_ms.input.fsdp": ("tokens", 4, lambda tr: marks.idle_ms(tr, "input")),
}


def _run(unit, chips, trace):
    return types.SimpleNamespace(unit=unit, chips=chips, trace=trace, root=REPO)


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_mark_reader_reads_its_phase_and_nothing_without_marks(name):
    unit, chips, want = READERS[name]
    read = spec.metric_reader(name, REPO).read
    got = read(_run(unit, chips, _trace()))
    assert got is not None and got == pytest.approx(want(_trace())) and got > 0
    assert read(_run(unit, chips, None)) is None  # a run without --trace 1
    assert read(_run(unit, chips, Trace([], [], 1.0, 2))) is None  # the CPU
    assert read(_run(unit, chips, _trace(name="tpujob_span_mark"))) is None  # unlabelled
    other = ("images" if unit == "tokens" else "tokens", chips) if chips == 1 else (unit, 1)
    assert read(_run(*other, _trace())) is None  # another family, or one card


def test_the_prefetch_wait_reader_reads_the_data_wait_span():
    read = spec.metric_reader("prefetch_wait_ms.resnet", REPO).read
    assert read(_run("images", 1, _trace(steps=3))) is None  # no data.wait span
    host = {"image": np.zeros((2, 4, 4, 3), np.uint8)}
    batches = data.prefetch(iter([host] * 3), "cpu")
    try:
        with _capture():
            for _ in range(3):
                next(batches)
    finally:
        batches.close()
    wait = stepstats.span_totals()["data.wait"]
    got = read(_run("images", 1, _trace(steps=3)))
    assert got == pytest.approx(1e3 * wait["seconds"] / 3)
    assert read(_run("images", 1, _trace(steps=2))) is None  # not one wait a traced step
    assert read(_run("images", 1, None)) is None
    assert read(_run("tokens", 1, _trace(steps=3))) is None


def test_benchmark_lists_each_new_reader_with_its_cells():
    bench = spec.benchmark(REPO)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name in [*READERS, "prefetch_wait_ms.resnet"]:
        m = per_layer[name]
        assert set(m["workloads"]) <= cells and m["workloads"]
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics", f"{name}.py"))
        moved = {e["name"]: e for e in bench["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
