"""The ``tensor=2`` step in bf16 on the CPU: the port's gloo gang against the
JAX package's ``Trainer`` on the same plan, 4 steps of ``tiny()`` from the
JAX init tree (tests/test_torch_tensor_parallel.py's ranks and JAX run, at
``compute_dtype`` bf16 on both sides).

Three gaps, each the largest relative difference of the per-step losses
(and of the grad norms beside them):

- the port at ``tensor=2`` against JAX at ``tensor=2`` (the port's fault, if
  any: it is held to the bf16 bar, losses within 5e-3 relative);
- JAX at ``tensor=2`` against JAX at ``tensor=1``, and the port at
  ``tensor=2`` against the port at ``tensor=1``: what splitting the heads
  and the vocabulary does to bf16 sums in either package (recorded, and
  held to the same bar).

The gaps are printed as one JSON line (``pytest -s`` shows it).
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sharded_step import run_ranks  # noqa: E402
from test_torch_tensor_parallel import _jax_run, _rank, jax_tree_weights  # noqa: E402

STEPS = 4
TOL_LOSS = 5e-3


def _gap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_tensor_step_bf16_gaps_to_jax(tmp_path):
    tree, weights = jax_tree_weights(tmp_path)
    port, jax_side = {}, {}
    for tp in (1, 2):
        plan = f"tensor={tp}"
        port[tp] = run_ranks(__file__, tp, {
            "plan": plan, "weights": str(weights), "out": str(tmp_path / f"o{tp}.npz"),
            "remat": False, "steps": STEPS, "dtype": "bfloat16"})
        losses, norms, _, _ = _jax_run(plan, tree, STEPS, "bfloat16")
        jax_side[tp] = {"losses": losses, "norms": norms}
    gaps = {
        name: {"loss": _gap(a["losses"], b["losses"]), "grad_norm": _gap(a["norms"], b["norms"])}
        for name, a, b in (
            ("port_tp2_vs_jax_tp2", port[2], jax_side[2]),
            ("jax_tp2_vs_jax_tp1", jax_side[2], jax_side[1]),
            ("port_tp2_vs_port_tp1", port[2], port[1]),
        )
    }
    print(json.dumps({"bf16_tensor2_gaps": gaps, "port": port, "jax": jax_side}))
    for name, gap in gaps.items():
        assert gap["loss"] <= TOL_LOSS, (name, gaps)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
