"""The port's Llama worker as an elastic gang of processes on the CPU.

Each host is ``python -m mpi_operator_tpu_torch.workers.llama_worker --device
cpu`` with the operator's ``TPUJOB_*`` env, as the executor launches it;
ranks rendezvous over gloo at a free localhost port.

- SIGTERM on one rank: every rank checkpoints at the same step and exits 75,
  and the step-stats blob of host 0 has its compute and ckpt buckets.
- One host with two chips spawns two ranks; a hostfile of one line is no
  membership change (hosts are counted, not ranks), so it runs to done
  through its periodic checkpoints.
"""

import json
import os
import signal
import subprocess
import sys
import time

from mpi_operator_tpu_torch.ops.checkpoint import CheckpointManager
from mpi_operator_tpu_torch.ops.elastic import EXIT_RESTART
from mpi_operator_tpu_torch.runtime.stepstats import read_stats

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sharded_step import REPO, free_port  # noqa: E402

WORKER = [sys.executable, "-m", "mpi_operator_tpu_torch.workers.llama_worker", "--device", "cpu"]


def _hosts(tmp_path, n_hosts, env, chips=1):
    port = free_port()
    procs = []
    for h in range(n_hosts):
        host_env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                        TPUJOB_NUM_HOSTS=str(n_hosts),
                        TPUJOB_HOST_ID=str(h), TPUJOB_CHIPS_PER_HOST=str(chips),
                        TPUJOB_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                        TPUJOB_STEPSTATS_FILE=str(tmp_path / f"stats{h}.json"),
                        TPUJOB_STEPSTATS_INTERVAL="0", **env)
        with open(tmp_path / f"out{h}.log", "w") as out, \
                open(tmp_path / f"err{h}.log", "w") as err:
            procs.append(subprocess.Popen(WORKER, cwd=REPO, env=host_env, stdout=out,
                                          stderr=err))
    return procs


def _wait(procs, timeout=180):
    try:
        return [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def _record(tmp_path, host=0):
    return json.loads((tmp_path / f"out{host}.log").read_text().strip().splitlines()[-1])


def test_sigterm_on_one_rank_checkpoints_every_rank_at_one_step(tmp_path):
    ckpt = tmp_path / "ckpt"
    procs = _hosts(tmp_path, 2, {
        "LLAMA_CKPT": str(ckpt), "LLAMA_STEPS": "400", "LLAMA_SEQ": "16",
        "LLAMA_SAVE_EVERY": "1000", "LLAMA_CHECK_EVERY": "1", "LLAMA_STEP_SLEEP": "0.05",
        "LLAMA_PROGRESS_EVERY": "3",
    })
    try:
        deadline = time.monotonic() + 120
        while "progress: batch 3" not in (tmp_path / "out0.log").read_text():
            assert time.monotonic() < deadline, (tmp_path / "err0.log").read_text()[-3000:]
            assert all(p.poll() is None for p in procs), (tmp_path / "err0.log").read_text()
            time.sleep(0.1)
        procs[1].send_signal(signal.SIGTERM)
    finally:
        codes = _wait(procs)
    assert codes == [EXIT_RESTART, EXIT_RESTART], (tmp_path / "err1.log").read_text()[-3000:]
    record = _record(tmp_path)
    assert record["outcome"] == "restart" and 3 <= record["step"] < 400
    assert record["hosts"] == 2 and record["mesh"] == "data=2"
    assert len(record["losses"]) == record["step"]
    # the one forced save is at the step both ranks stopped at
    assert CheckpointManager(str(ckpt)).committed_steps() == [record["step"]]
    stats = read_stats(str(tmp_path / "stats0.json"))
    assert stats["step"] == record["step"] and stats["steps"] == record["step"]
    assert stats["buckets"]["compute"] > 0 and stats["buckets"]["ckpt"] > 0
    assert set(stats["buckets"]) == {"compile", "input", "compute", "sync", "ckpt"}


def test_one_host_with_two_chips_spawns_its_ranks_and_counts_hosts(tmp_path):
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    (cfg / "hostfile").write_text("llama-worker-0 slots=2\n")
    ckpt = tmp_path / "ckpt"
    procs = _hosts(tmp_path, 1, {
        "LLAMA_CKPT": str(ckpt), "LLAMA_STEPS": "4", "LLAMA_SEQ": "16",
        "LLAMA_SAVE_EVERY": "2", "LLAMA_CHECK_EVERY": "1", "LLAMA_MESH": "fsdp=2",
        "TPUJOB_CONFIG_DIR": str(cfg),
    }, chips=2)
    assert _wait(procs) == [0], (tmp_path / "err0.log").read_text()[-3000:]
    record = _record(tmp_path)
    assert (record["outcome"], record["step"], record["start_step"]) == ("done", 4, 0)
    assert record["mesh"] == "fsdp=2" and record["hosts"] == 1 and len(record["losses"]) == 4
    assert CheckpointManager(str(ckpt)).committed_steps() == [2, 4]
