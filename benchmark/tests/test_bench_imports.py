"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
reference imports nothing of the program either (an AST scan; top-level
module names are compared whole, so ``mpi_operator_tpu_torch`` is not
``mpi_operator_tpu``)."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mpi_operator_tpu"}
PROGRAM = "mpi_operator_tpu_torch"


def _modules():
    for dirpath, _, files in os.walk(BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_tops(path):
    """Top-level names of every module ``path`` imports (relative imports
    are the benchmark's own)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", list(_modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in _modules() if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(imported_tops(path))


def test_the_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom mpi_operator_tpu.models import llama\n"
                   "import mpi_operator_tpu_torch\n")
    assert set(imported_tops(str(bad))) == {"jax", "mpi_operator_tpu", PROGRAM}
