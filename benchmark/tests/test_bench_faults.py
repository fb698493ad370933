"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a tiny cell on the CPU (the harness's look
for a card is the command's, and is skipped here) with one fault of
``benchmark.faults`` planted in the program, for each fault the cell can
have: a step that returns its state unchanged, half of the batch left out
with the mean taken over the rest, an answer altered where it is produced
(the largest leaf's update applied twice; momentum SGD's coefficient taken
as 0), and, on the cell over four ranks (gloo, one process each), the
exchange of the gradients between them left out.
"""

import time

import pytest
import torch

from benchmark import faults, harness, spec

import tiny

CPU = torch.device("cpu")
CELLS = list(tiny.CELLS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _run(root, cell, seed=11, fault=""):
    if cell == tiny.GANG:
        out, _ = harness.execute_ranks(cell, seed, 0.2, False, time.perf_counter(), root,
                                       device_type="cpu", fault=fault)
        return out
    if not fault:
        out, _ = harness.execute(cell, seed, 0.2, False, CPU, time.perf_counter(), root)
        return out
    with faults.planted(fault):
        out, _ = harness.execute(cell, seed, 0.2, False, CPU, time.perf_counter(), root)
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]


def _cases():
    """(cell, fault) for each fault each tiny cell can have."""
    out = []
    for cell, (_, cfg, *_rest, chips, _mesh) in tiny.CELLS.items():
        stand_in = spec.Cell(cell, {"chips": chips}, cfg, {}, [], [])
        out += [(cell, f) for f in faults.FAULTS if faults.applies(f, stand_in)]
    return out


@pytest.mark.parametrize("cell,fault", _cases())
def test_fault_is_not_correct(root, cell, fault):
    out = _run(root, cell, fault=fault)
    assert not out["correct"], out["checks"]


def test_faults_are_removed_after_the_block(root):
    from mpi_operator_tpu_torch.ops import data
    from mpi_operator_tpu_torch.ops.trainer import Trainer

    step, batch = Trainer.train_step, data.make_global_batch
    for fault in faults.FAULTS:
        with faults.planted(fault):
            pass
    assert (Trainer.train_step, data.make_global_batch) == (step, batch)
