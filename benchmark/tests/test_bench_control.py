"""The control fails each cell's comparison, on the card at the cell's own
size: the program's bf16 products replaced by the precision below
(``benchmark.calibrate --control``; the family's ``control`` says which).
Needs a CUDA card, and a few minutes a cell.

    python -m pytest -m cuda benchmark/tests/test_bench_control.py
"""

import json
import os
import subprocess
import sys

import pytest

from benchmark import spec

import tiny


def _cells():
    return [w["name"] for w in spec.benchmark(tiny.ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_control_is_not_correct(cell):
    import torch

    chips = spec.load_cell(cell, tiny.ROOT).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s): the control runs at the cell's size")
    proc = subprocess.run([sys.executable, "-m", "benchmark.calibrate", "--workload", cell,
                           "--seeds", str(2 ** 32 + 17), "--control"], cwd=tiny.ROOT,
                          capture_output=True, text=True, timeout=1200,
                          env={**os.environ, "PYTHONPATH": tiny.ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    numbers = json.loads(proc.stdout.strip().splitlines()[-1])["numbers"]
    limits = spec.load_cell(cell, tiny.ROOT).spec["limits"]
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)
