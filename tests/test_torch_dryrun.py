"""The port's multi-device dry run (``mpi_operator_tpu_torch.dryrun``), the
twin of ``__graft_entry__.dryrun_multichip``: the same plan for every
device count, and one finite step of ``tiny()`` on 8 gloo CPU ranks
(``fsdp=2,tensor=2,sequence=2``), then the DCN step on two slices, the EP
step (8-way experts) and the PP step (4 stages beside ``data=2``).
"""

import math
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__ as graft  # noqa: E402
from mpi_operator_tpu_torch import dryrun  # noqa: E402


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 32])
def test_plan_for_is_the_jax_dry_runs(n):
    ours, theirs = dryrun._plan_for(n), graft._plan_for(n)
    assert ours.axes == theirs.axes and ours.ordered() == theirs.ordered()


def test_dryrun_takes_one_finite_step_on_eight_gloo_ranks(capfd):
    record = dryrun.dryrun_multichip(8, device="cpu", timeout=300)
    assert record["mesh"] == {"fsdp": 2, "sequence": 2, "tensor": 2}
    assert (record["batch"], record["seq_len"]) == (8, 32)
    assert math.isfinite(record["loss"]) and math.isfinite(record["dcn_loss"])
    err = capfd.readouterr().err
    assert "[dryrun] OK: 8 devices" in err and "[dryrun] DCN OK: 2 slices x 4 devices" in err
    assert "[dryrun] EP OK: 8-way experts" in err and "[dryrun] PP OK: 4-stage pipeline" in err
    assert (record["ep_experts"], record["pp_stages"]) == (8, 4)
    assert record["ep_diff"] <= dryrun.TOL_LOCAL and record["pp_diff"] <= dryrun.TOL_LOCAL


def test_dryrun_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(2)
