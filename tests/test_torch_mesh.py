"""The port's copies of the JAX package's mesh, sharding-rule and step-stats
pieces, held to the originals; what the rules send to each mesh axis of
the Llama path (``tensor`` splits, ``sequence``, ``expert`` and ``pipe``
replicate), and the checks on what cannot split.

- ``MeshPlan`` (parse, ordered, sizes, errors), ``_hybrid_flat_mesh``'s
  slice-major layout and ``mesh_from_context``'s checks;
- ``DEFAULT_RULES``, ``logical_spec`` and ``mesh_filtered_spec`` over a table
  of specs, and the Llama model's logical axes;
- the step-stats blob for a scripted clock, byte for byte (the executor
  mirrors it unchanged).
"""

import json
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mpi_operator_tpu.machinery import objects as jax_objects
from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu.parallel import sharding as jsharding
from mpi_operator_tpu.runtime import stepstats as jstepstats
from mpi_operator_tpu.runtime import topology as jtopology
from mpi_operator_tpu_torch.kernels import flash_attention as tfa
from mpi_operator_tpu_torch.models import llama as tllama
from mpi_operator_tpu_torch.parallel import sharding
from mpi_operator_tpu_torch.runtime import stepstats, topology

SPECS = ["", "fsdp=2", "data=2,fsdp=2", "fsdp=4,tensor=2", "tensor=2,data=4",
         "pipe=2,expert=2,sequence=2", "data=1", "fsdp=2,data=3,sequence=1"]


@pytest.mark.parametrize("spec, dcn", [(s, "") for s in SPECS] + [
    ("data=2,fsdp=2", "data=2"), ("fsdp=2", "data=2"), ("data=2", "data=2,fsdp=2"),
])
def test_mesh_plan_matches_jax(spec, dcn):
    ours, theirs = topology.MeshPlan.parse(spec, dcn), jtopology.MeshPlan.parse(spec, dcn)
    assert (ours.axes, ours.dcn) == (theirs.axes, theirs.dcn)
    assert ours.ordered() == theirs.ordered()
    assert (ours.ici_size, ours.dcn_size, ours.total_devices) == \
        (theirs.ici_size, theirs.dcn_size, theirs.total_devices)
    ici = [ours.axes.get(n, 1) for n, _ in ours.ordered()]
    dcn_shape = [ours.dcn.get(n, 1) for n, _ in ours.ordered()]
    ranks = np.arange(ours.total_devices)
    np.testing.assert_array_equal(topology._hybrid_flat_mesh(ici, dcn_shape, ranks),
                                  jtopology._hybrid_flat_mesh(ici, dcn_shape, ranks))


@pytest.mark.parametrize("bad", ["fsdp=banana", "warp=2", "fsdp=0", "fsdp=2,fsdp=4", "data"])
def test_mesh_plan_errors_match_jax(bad):
    with pytest.raises(ValueError) as theirs:
        jtopology.MeshPlan.parse(bad)
    with pytest.raises(ValueError, match="^" + str(theirs.value).replace("(", r"\(")
                       .replace(")", r"\)") + "$"):
        topology.MeshPlan.parse(bad)
    assert topology.MESH_AXES == jtopology.MESH_AXES
    assert topology.MeshPlan.data_parallel(3) == topology.MeshPlan(axes={"data": 3})


def test_mesh_axes_always_carry_data_and_fsdp():
    assert topology.mesh_axes(topology.MeshPlan.parse("fsdp=2")) == (("data", 1), ("fsdp", 2))
    assert topology.mesh_axes(topology.MeshPlan.parse("tensor=2,data=2")) == \
        (("data", 2), ("fsdp", 1), ("tensor", 2))


def test_mesh_from_context_checks_the_gang(monkeypatch):
    from mpi_operator_tpu_torch.runtime.bootstrap import context_from_env

    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    built = []
    monkeypatch.setattr(topology, "build_mesh", lambda plan, dev: built.append(plan) or plan)
    ctx = context_from_env({"TPUJOB_NUM_HOSTS": "2", "TPUJOB_CHIPS_PER_HOST": "4"})
    with pytest.raises(RuntimeError, match="rendezvous and placement disagree"):
        topology.mesh_from_context(ctx)
    two_slices = context_from_env({"TPUJOB_NUM_HOSTS": "2", "TPUJOB_NUM_SLICES": "2"})
    assert topology.mesh_from_context(two_slices) == \
        topology.MeshPlan(axes={"data": 2}, dcn={"data": 2})
    with pytest.raises(ValueError, match="LLAMA_MESH_DCN='data=2'"):
        topology.mesh_from_context(two_slices, topology.MeshPlan.parse("fsdp=4"))
    assert topology.mesh_from_context(None) == topology.MeshPlan.data_parallel(4)


LOGICAL = [
    ("batch",), ("batch", "seq", "embed"), ("vocab", "embed"), ("embed", "vocab"),
    ("embed", "heads"), ("heads", "embed"), ("embed", "mlp"), ("mlp", "embed"),
    ("stats",), (None, "embed", "kv_heads"), ("embed", "embed"), ("expert", "embed", "mlp"),
    ("conv_kernel", "conv_kernel", "conv_in", "conv_out"), ("qkv", "head_dim"), (),
]
MESHES = [("fsdp",), ("data", "fsdp"), ("data",), ("data", "fsdp", "tensor"),
          ("data", "fsdp", "pipe", "expert", "sequence", "tensor")]


def test_rules_and_specs_match_jax():
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    rules_variants = [None, {**jsharding.DEFAULT_RULES, "embed": ("fsdp", "tensor")}]
    devices = jax.devices()
    for rules in rules_variants:
        for axes in LOGICAL:
            theirs = jsharding.logical_spec(axes, rules)
            ours = sharding.logical_spec(axes, rules)
            assert ours == tuple(theirs), axes
            for names in MESHES:
                mesh = Mesh(np.array(devices[:1]).reshape((1,) * len(names)), names)
                assert sharding.mesh_filtered_spec(ours, names) == \
                    tuple(jsharding.mesh_filtered_spec(theirs, mesh)), (axes, names)


def test_logical_axes_are_the_jax_models():
    theirs = jllama.logical_axes(jllama.tiny())
    ours = tllama.logical_axes(tllama.tiny())
    assert len(ours) == 3 + 9 * tllama.tiny().n_layers
    for (group, leaf), name in tllama._TOP_LEAVES.items():
        assert ours[name] == theirs[group][leaf]
    for (group, leaf), name in tllama._LAYER_LEAVES.items():
        for i in range(tllama.tiny().n_layers):
            # the JAX tree stacks the layers on a leading, replicated axis
            assert (None, *ours[f"layers.{i}.{name}"]) == theirs["layers"][group][leaf]
    # the shard dims the rules give FSDP2: "embed" → dim 0 of wq, dim 1 of wo
    names = ("data", "fsdp")
    assert sharding.fsdp_dim(ours["layers.0.wq"], names) == 0
    assert sharding.fsdp_dim(ours["layers.0.wo"], names) == 1
    assert sharding.fsdp_dim(ours["embed"], names) == 1
    assert sharding.fsdp_dim(ours["final_norm"], names) is None


def _fake_mesh(**sizes):
    return types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 mesh=np.zeros(tuple(sizes.values())))


@pytest.mark.parametrize("axis", ["tensor", "sequence", "expert", "pipe"])
def test_shard_model_refuses_unported_axes(axis):
    """No axis of the Llama path is refused any more (the multi-rank tests
    in tests/test_torch_tensor_parallel.py and
    tests/test_torch_replica_axes.py run over each): the rules send the
    head, FFN and vocab dimensions to ``tensor`` and nothing to
    ``sequence``, ``expert`` or ``pipe`` (the Llama names neither of the
    last two, so their ranks are replicas), and heads that ``tensor`` does
    not divide raise ``ValueError`` before anything is sharded, whatever
    axis sits beside it."""
    import dataclasses

    assert not hasattr(sharding, "refuse_unported_axes")
    names = ("data", "fsdp", axis)
    axes = tllama.logical_axes(tllama.tiny())
    split = {n: sharding.shard_dim(a, names, axis) for n, a in axes.items()}
    if axis == "tensor":
        assert {n.split(".")[-1]: d for n, d in split.items()} == {
            "embed": 0, "lm_head": 1, "final_norm": None, "attn_norm": None, "mlp_norm": None,
            "wq": 1, "wk": 1, "wv": 1, "wo": 0, "w_gate": 1, "w_up": 1, "w_down": 0}
    else:
        assert set(split.values()) == {None}
    odd = tllama.Llama(dataclasses.replace(tllama.tiny(), n_heads=6, n_kv_heads=3), device="meta")
    with pytest.raises(ValueError, match="tensor=2 does not divide n_heads=6 and n_kv_heads=3"):
        sharding.shard_model(odd, _fake_mesh(data=1, fsdp=1, **{axis: 2, "tensor": 2}))


def test_flash_attention_mesh_runs_locally_and_refuses_tensor_parallel():
    """With a mesh the inputs are this rank's batch and, over ``tensor``, its
    heads: attention runs on them as they are. Local heads that do not form
    whole GQA groups, and a sequence split over ``sequence`` (the ring's
    job), raise ``ValueError``."""
    q = torch.randn(1, 16, 4, 16)
    k = v = torch.randn(1, 16, 2, 16)
    alone = tfa.flash_attention(q, k, v, block_q=16, block_k=16)
    for mesh in (_fake_mesh(data=2, fsdp=2), _fake_mesh(data=1, fsdp=2, tensor=2)):
        local = tfa.flash_attention(q, k, v, mesh=mesh, block_q=16, block_k=16)
        assert torch.equal(local, alone)
    with pytest.raises(ValueError, match="3 q heads do not group over its 2 kv heads"):
        tfa.flash_attention(q[:, :, :3], k, v, mesh=_fake_mesh(data=1, fsdp=2, tensor=2))
    with pytest.raises(ValueError, match="use ring_attention"):
        tfa.flash_attention(q, k, v, mesh=_fake_mesh(data=1, fsdp=1, sequence=2))


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _script(recorder_cls, path, clock):
    rec = recorder_cls(path, interval=0.0, clock=clock)
    for step in range(1, 4):
        for bucket, dt in (("input", 0.1), ("compute", 2.0 if step == 1 else 0.5),
                           ("sync", 0.05), ("ckpt", 0.3 if step == 2 else 0.0)):
            with rec.phase(bucket):
                clock.t += dt
        rec.step_done(step + 10)
    rec.set_profile("req-1", "capturing", "/p")
    rec.close()
    return rec.snapshot()


def test_step_stats_blob_is_the_jax_recorders(tmp_path, monkeypatch):
    assert stepstats.TRAIN_BUCKETS == jax_objects.TRAIN_BUCKETS
    assert (stepstats.ENV_STATS_FILE, stepstats.ENV_STATS_INTERVAL) == \
        (jstepstats.ENV_STATS_FILE, jstepstats.ENV_STATS_INTERVAL)
    ours = _script(stepstats.StepStatsRecorder, str(tmp_path / "a.json"), _Clock())
    theirs = _script(jstepstats.StepStatsRecorder, str(tmp_path / "b.json"), _Clock())
    assert json.dumps(ours) == json.dumps(theirs)
    a = stepstats.read_stats(str(tmp_path / "a.json"))
    b = jstepstats.read_stats(str(tmp_path / "b.json"))
    for blob in (a, b):
        blob.pop("t")
    assert json.dumps(a) == json.dumps(b)
    for args in ({"step": "x", "buckets": {"compute": "1.23456", "bogus": 3}},
                 {"buckets": [1], "profile": {"id": "z" * 300}, "compile_cache": {"hits": 2}}):
        assert stepstats.bounded_train_stats(**args) == jax_objects.bounded_train_stats(**args)
