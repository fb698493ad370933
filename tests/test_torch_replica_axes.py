"""``expert`` and ``pipe`` as replica axes of the port's Llama step (gloo CPU
gangs) against the JAX package's ``Trainer`` on the same plan.

The JAX Llama names neither axis and its rules split the rows over
``data`` × ``fsdp`` only, so the ranks of one (``data``, ``fsdp``)
coordinate compute the same step on the same parameters: the port runs
FSDP2 on each such coordinate's (``data``, ``fsdp``) sub-mesh and reduces
nothing over the replica axes. Held per step, 4 steps, f32: loss and grad
norm within 1e-5 relative, each parameter after the last step within 1e-4
in relative norm, and each parameter's shard dimensions the JAX
``NamedSharding``'s (tests/test_torch_tensor_parallel.py's
:func:`check_step_against_jax`, whose ``_rank`` the ranks run). A
checkpoint saved on ``expert=2`` restoring on a plan without it is
tests/test_torch_checkpoint.py's.
"""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tensor_parallel import _rank, check_step_against_jax  # noqa: E402

STEPS = 4


@pytest.mark.parametrize("plan", ["expert=2", "pipe=2", "data=2,expert=2"])
def test_replica_axes_step_matches_jax_trainer(plan, tmp_path):
    check_step_against_jax(plan, tmp_path, script=__file__, steps=STEPS)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
