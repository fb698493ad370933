"""The port's collectives on a 4-rank gloo CPU gang against the JAX
package's, run under ``shard_map`` on 4 virtual CPU devices.

Every verb runs over each axis of a ``data=2,sequence=2`` mesh (sub-groups
whose members are not consecutive ranks, so point-to-point peers must be
global ranks) and over a one-axis ring of all 4 ranks. Rank r's input is
row r of one global array on both sides; the outputs, stacked in rank
order, must be equal (exact: the sums are of two or four f32 values, and
max, min, gathers and shifts move values unchanged; the tolerance, 1e-6,
covers a different summation order). Beside them, Megatron's conjugate
pair: ``copy_to_tp`` is the identity whose backward sums over the group,
``reduce_from_tp`` the sum whose backward is the identity.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sharded_step import gang, run_ranks  # noqa: E402

SHAPE = (4, 4, 6)  # rank r holds row r: [1, 4, 6]
# (name, JAX call, port call): x is this rank's [1, 4, 6], ax the JAX axis
# name, g the port's process group
VERBS = [
    ("psum", lambda c, x, ax: c.psum(x, ax), lambda c, x, g: c.psum(x, g)),
    ("pmean", lambda c, x, ax: c.pmean(x, ax), lambda c, x, g: c.pmean(x, g)),
    ("pmax", lambda c, x, ax: c.pmax(x, ax), lambda c, x, g: c.pmax(x, g)),
    ("pmin", lambda c, x, ax: c.pmin(x, ax), lambda c, x, g: c.pmin(x, g)),
    ("reduce_to_root", lambda c, x, ax: c.reduce_to_root(x, ax),
     lambda c, x, g: c.reduce_to_root(x, g)),
    ("broadcast_root", lambda c, x, ax: c.broadcast_root(x, ax),
     lambda c, x, g: c.broadcast_root(x, g)),
    ("all_gather_tiled", lambda c, x, ax: c.all_gather(x, ax, gather_axis=1, tiled=True),
     lambda c, x, g: c.all_gather(x, g, gather_axis=1, tiled=True)),
    ("all_gather_stacked", lambda c, x, ax: c.all_gather(x, ax, gather_axis=1),
     lambda c, x, g: c.all_gather(x, g, gather_axis=1)),
    ("reduce_scatter", lambda c, x, ax: c.reduce_scatter(x, ax, scatter_axis=1),
     lambda c, x, g: c.reduce_scatter(x, g, scatter_axis=1)),
    ("all_to_all", lambda c, x, ax: c.all_to_all(x, ax, split_axis=1, concat_axis=2),
     lambda c, x, g: c.all_to_all(x, g, split_axis=1, concat_axis=2)),
    ("ring_shift", lambda c, x, ax: c.ring_shift(x, ax, shift=1),
     lambda c, x, g: c.ring_shift(x, g, shift=1)),
    ("ring_shift_back", lambda c, x, ax: c.ring_shift(x, ax, shift=-1),
     lambda c, x, g: c.ring_shift(x, g, shift=-1)),
    ("axis_index", lambda c, x, ax: x * 0 + c.axis_index(ax),
     lambda c, x, g: x * 0 + c.axis_index(g)),
    ("axis_size", lambda c, x, ax: x * 0 + c.axis_size(ax),
     lambda c, x, g: x * 0 + c.axis_size(g)),
]
AXES = ["data", "sequence", "ring"]


def _global():
    return np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)


def _rank(local_rank, args):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from mpi_operator_tpu_torch.parallel import collectives as c
    from mpi_operator_tpu_torch.runtime import bootstrap

    mesh = gang(local_rank, "data=2,sequence=2")
    ring = init_device_mesh("cpu", (4,), mesh_dim_names=("ring",))
    groups = {"data": mesh.get_group("data"), "sequence": mesh.get_group("sequence"),
              "ring": ring.get_group("ring")}
    r = dist.get_rank()
    x = torch.from_numpy(_global()[r:r + 1])
    out = {f"{axis}-{name}": port(c, x, groups[axis]).numpy()
           for axis in AXES for name, _, port in VERBS}
    # the conjugate pair over "sequence": gradients of sum(f(x) * coef)
    coef = torch.full((3,), float(r + 1))
    xc = torch.ones(3, requires_grad=True)
    (c.copy_to_tp(xc, groups["sequence"]) * coef).sum().backward()
    xr = torch.full((3,), float(r), requires_grad=True)
    y = c.reduce_from_tp(xr, groups["sequence"])
    (y * coef).sum().backward()
    out.update(copy_grad=xc.grad.numpy(), reduce_value=y.detach().numpy(),
               reduce_grad=xr.grad.numpy())
    np.savez(os.path.join(args["dir"], f"rank{r}.npz"), **out)
    if r == 0:
        print(json.dumps({"ok": True}))
    bootstrap.shutdown()


def _jax_outputs():
    """axis-verb → the JAX verb's output, stacked over the 4 devices."""
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from mpi_operator_tpu.jaxcompat import shard_map
    from mpi_operator_tpu.parallel import collectives as jc

    devices = np.array(jax.devices()[:4])
    meshes = {"data": (Mesh(devices.reshape(2, 2), ("data", "sequence")), P(("data", "sequence"))),
              "ring": (Mesh(devices, ("ring",)), P("ring"))}
    meshes["sequence"] = meshes["data"]
    x = jax.numpy.asarray(_global())
    out = {}
    for axis in AXES:
        mesh, spec = meshes[axis]
        for name, theirs, _ in VERBS:
            fn = shard_map(lambda v, f=theirs, a=axis: f(jc, v, a), mesh=mesh, in_specs=spec,
                           out_specs=spec, check_vma=False)
            out[f"{axis}-{name}"] = np.asarray(jax.jit(fn)(x))
    return out


@pytest.fixture(scope="module")
def port_outputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    run_ranks(__file__, 4, {"dir": str(d)})
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("axis", AXES)
def test_collectives_match_jax_under_shard_map(axis, port_outputs):
    want = _jax_outputs()
    for name, _, _ in VERBS:
        key = f"{axis}-{name}"
        got = np.concatenate([r[key] for r in port_outputs], axis=0)
        np.testing.assert_allclose(got, want[key], rtol=1e-6, atol=1e-6, err_msg=key)


def test_copy_to_tp_and_reduce_from_tp_are_conjugate(port_outputs):
    # "sequence" pairs ranks (0, 1) and (2, 3)
    for r, out in enumerate(port_outputs):
        pair = (r // 2 * 2, r // 2 * 2 + 1)
        # copy_to_tp: d/dx of sum(x * coef_r) summed over the pair
        np.testing.assert_array_equal(out["copy_grad"], np.full(3, sum(p + 1 for p in pair)))
        # reduce_from_tp: the pair's sum forward, the rank's own coef backward
        np.testing.assert_array_equal(out["reduce_value"], np.full(3, float(sum(pair))))
        np.testing.assert_array_equal(out["reduce_grad"], np.full(3, float(r + 1)))


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
