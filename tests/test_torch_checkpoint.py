"""The port's DCP checkpoints and its elastic loop.

- Reshard on load: a checkpoint of a 4-rank ``data=2,fsdp=2`` gang restores
  onto a 2-rank ``fsdp=2`` gang with every parameter and moment bitwise
  equal (ranks are fresh processes, gloo on the CPU).
- Without a replica axis: a checkpoint of ``fsdp=2,expert=2`` (or
  ``pipe=2``) restores bitwise onto ``fsdp=2``.
- Across ``tensor`` sizes: a checkpoint of a ``fsdp=2,tensor=2`` gang
  restores onto ``tensor=2`` and onto ``fsdp=2``; the restored runs' losses
  equal the unbroken run's within 1e-6 relative (the tensor-parallel sums
  round in another order).
- The elastic full cycle (≙ tests/test_elastic.py's): a membership change
  checkpoints and returns "restart"; the next incarnation restores and runs
  to "done"; the losses of the two equal an uninterrupted run's, bitwise.
- A save that never committed is never restored.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.models import llama
from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
from mpi_operator_tpu_torch.ops.checkpoint import CheckpointManager
from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
from mpi_operator_tpu_torch.ops.elastic import EXIT_RESTART, ElasticConfig, run_elastic

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sharded_step import gang, run_ranks  # noqa: E402

CFG = dataclasses.replace(llama.tiny(), compute_dtype=torch.float32)


def _rank(local_rank, args):
    """Train 2 steps and save (phase "save"), or restore into a model from
    another seed (phase "restore"); rank 0 writes every full tensor."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from mpi_operator_tpu_torch.ops.checkpoint import state_dict
    from mpi_operator_tpu_torch.runtime import bootstrap

    mesh = gang(local_rank, args["plan"])
    model = llama.init(CFG, torch.Generator().manual_seed(args["seed"]), "cpu")
    trainer = Trainer(llama.loss_fn, TrainerConfig(learning_rate=1e-2, adam_mu_bf16=True),
                      mesh=mesh)
    state = trainer.init_state(model)
    mgr = CheckpointManager(args["dir"])
    if args["phase"] in ("train", "resume"):
        stream = synthetic_tokens(global_batch=4, seq_len=16, vocab=CFG.vocab)
        if args["phase"] == "resume":
            state = mgr.restore(state)
        start, losses = state.step, []
        while state.step < args["steps"]:
            state, m = trainer.train_step(state, make_global_batch(next(stream), "cpu", mesh))
            losses.append(m["loss"].item())
            if state.step == args.get("save_at"):
                mgr.save(state.step, state, force=True)
        mgr.wait()
        if dist.get_rank() == 0:
            print(json.dumps({"start": start, "losses": losses}))
        bootstrap.shutdown()
        return
    if args["phase"] == "save":
        stream = synthetic_tokens(global_batch=4, seq_len=16, vocab=CFG.vocab)
        for _ in range(2):
            state, _ = trainer.train_step(state, make_global_batch(next(stream), "cpu", mesh))
        mgr.save(state.step, state, force=True)
        mgr.wait()
    else:
        state = mgr.restore(state)
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            elif isinstance(v, torch.Tensor):
                t = v.full_tensor() if isinstance(v, DTensor) else v
                flat[prefix + k] = t.detach().float().numpy()

    walk("", state_dict(state))
    if dist.get_rank() == 0:
        np.savez(args["out"], **flat)
        print(json.dumps({"step": state.step}))
    bootstrap.shutdown()


def test_four_rank_checkpoint_restores_bitwise_on_two_ranks(tmp_path):
    common = {"dir": str(tmp_path / "ckpt")}
    saved = run_ranks(__file__, 4, {**common, "phase": "save", "plan": "data=2,fsdp=2",
                                    "seed": 0, "out": str(tmp_path / "a.npz")})
    restored = run_ranks(__file__, 2, {**common, "phase": "restore", "plan": "fsdp=2",
                                       "seed": 1, "out": str(tmp_path / "b.npz")})
    assert saved == restored == {"step": 2}
    a, b = dict(np.load(tmp_path / "a.npz")), dict(np.load(tmp_path / "b.npz"))
    assert set(a) == set(b) and len(a) == 3 * len(list(llama.logical_axes(CFG)))
    for name in a:
        assert np.array_equal(a[name], b[name]), name
    assert os.path.exists(tmp_path / "ckpt" / "2" / ".metadata")


@pytest.mark.parametrize("plan", ["fsdp=2,expert=2", "fsdp=2,pipe=2"])
def test_replica_axis_checkpoint_restores_bitwise_without_it(plan, tmp_path):
    """A gang whose ``expert`` or ``pipe`` ranks are replicas saves each shard
    once (DCP keeps one copy of what several ranks hold) and restores onto
    a plan without the replica axis, every parameter and moment bitwise."""
    common = {"dir": str(tmp_path / "ckpt")}
    saved = run_ranks(__file__, 4, {**common, "phase": "save", "plan": plan,
                                    "seed": 0, "out": str(tmp_path / "a.npz")})
    restored = run_ranks(__file__, 2, {**common, "phase": "restore", "plan": "fsdp=2",
                                       "seed": 1, "out": str(tmp_path / "b.npz")})
    assert saved == restored == {"step": 2}
    a, b = dict(np.load(tmp_path / "a.npz")), dict(np.load(tmp_path / "b.npz"))
    assert set(a) == set(b) and len(a) == 3 * len(list(llama.logical_axes(CFG)))
    for name in a:
        assert np.array_equal(a[name], b[name]), name


def test_tensor_parallel_checkpoint_restores_on_other_tensor_sizes(tmp_path):
    common = {"dir": str(tmp_path / "ckpt"), "steps": 4}
    unbroken = run_ranks(__file__, 4, {**common, "phase": "train", "plan": "fsdp=2,tensor=2",
                                       "seed": 0, "save_at": 2})
    assert unbroken["start"] == 0 and len(unbroken["losses"]) == 4
    for plan in ("tensor=2", "fsdp=2"):
        resumed = run_ranks(__file__, 2, {**common, "phase": "resume", "plan": plan, "seed": 1})
        assert resumed["start"] == 2, plan
        np.testing.assert_allclose(resumed["losses"], unbroken["losses"][2:], rtol=1e-6,
                                   err_msg=plan)


def _batches():
    for b in synthetic_tokens(global_batch=2, seq_len=16, vocab=CFG.vocab):
        yield make_global_batch(b, "cpu")


def test_elastic_full_cycle_restarts_resumes_and_matches_an_unbroken_run(tmp_path):
    trainer = Trainer(llama.loss_fn, TrainerConfig(learning_rate=1e-2))

    def init_state():
        return trainer.init_state(llama.init(CFG, torch.Generator().manual_seed(0), "cpu"))

    econf = ElasticConfig(checkpoint_dir=str(tmp_path / "ckpt"), save_interval_steps=3,
                          membership_check_every=2)
    calls = {"n": 0}

    def membership():
        calls["n"] += 1
        return 8 if calls["n"] < 2 else 4  # the declared gang shrinks

    res = run_elastic(trainer, _batches(), total_steps=10, config=econf,
                      init_state=init_state, membership=membership, current_world=8)
    assert res.outcome == "restart" and res.exit_code == EXIT_RESTART
    assert res.last_step == 4 and res.steps_run == 4 and len(res.losses) == 4
    mgr = CheckpointManager(econf.checkpoint_dir)
    assert mgr.committed_steps() == [3, 4]

    res2 = run_elastic(trainer, _batches(), total_steps=8, config=econf,
                       init_state=init_state, membership=lambda: 4, current_world=4)
    assert res2.outcome == "done" and res2.exit_code == 0
    assert (res2.start_step, res2.last_step) == (4, 8) and len(res2.losses) == 4

    unbroken = run_elastic(
        trainer, _batches(), total_steps=8, init_state=init_state, membership=lambda: 1,
        current_world=1, config=dataclasses.replace(econf, checkpoint_dir=str(tmp_path / "u")),
    )
    assert res.losses + res2.losses == unbroken.losses
    assert res2.metrics["loss"] == unbroken.losses[-1]
    # max_to_keep=3: the saves at 3, 4 (forced), 6 and 8 leave the last three
    assert mgr.committed_steps() == [4, 6, 8]


def test_a_save_that_never_committed_is_never_restored(tmp_path):
    trainer = Trainer(llama.loss_fn, TrainerConfig())
    state = trainer.init_state(llama.init(CFG, torch.Generator().manual_seed(0), "cpu"))
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore(state)
    state.step = 5
    assert mgr.save(5, state, force=True) and not mgr.save(7, state)
    mgr.wait()
    os.makedirs(tmp_path / "9")  # a save killed before its commit marker landed
    (tmp_path / "9" / "__0_0.distcp").write_bytes(b"partial")
    assert mgr.latest_step() == 5 and mgr.committed_steps() == [5]
    state.step = 0
    assert mgr.restore(state).step == 5


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
