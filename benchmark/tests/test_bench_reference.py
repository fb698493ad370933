"""The port's ``Trainer.train_step`` agrees with the plain references on the
CPU at tiny widths, on the weights and batches the benchmark draws from one
seed: the losses, the first gradients, the updates, and batch norm's
running statistics."""

import dataclasses

import pytest
import torch

from benchmark import readings, spec, traffic
from benchmark.families import decoder, resnet
from benchmark.reference import decoder as ref_decoder
from benchmark.reference import optim

import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _f32(cell):
    config = {**cell.config, "assumed": {**cell.config["assumed"], "compute_dtype": "float32"}}
    return dataclasses.replace(cell, config=config)


@pytest.mark.parametrize("seed", [0, 2 ** 40 + 3])
def test_decoder_readings_agree(root, seed):
    cell = spec.load_cell("tiny-decoder.t48", root)
    session = decoder.Session(cell, seed, CPU)
    prog = session.first_steps(3)
    numbers = readings.compare(prog, decoder.reference(cell, seed, CPU, 3))
    # bf16 compute against the f32 reference
    assert numbers["loss"]["value"] < 1e-3
    assert numbers["grad"]["value"] < 1e-2
    assert numbers["change"]["value"] < 1e-2


def test_decoder_update_matches_elementwise_in_f32(root):
    """At f32 compute the program's weights after two steps, and its first
    gradient from AdamW's state, are the reference's to rounding."""
    cell = _f32(spec.load_cell("tiny-decoder.t48", root))
    session = decoder.Session(cell, 5, CPU)
    session.step()
    b2 = cell.config["assumed"]["beta2"]
    g_prog = {n: (t / (1 - b2)).sqrt() for n, t in session.state.opt_state["nu"].items()}
    session.step()
    params = dict(session.state.params.named_parameters())

    w = dict(decoder.draw(cell.config, 5, CPU))
    batches = [torch.from_numpy(b["tokens"]).long()
               for b in traffic.pool(cell.traffic, cell.config, 5, CPU)[:2]]
    seen = {}
    ref_decoder.train(w, batches, cell.config,
                      lambda step, g: seen.update({n: t.abs() for n, t in g.items()})
                      if step == 1 else None)
    for n, t in w.items():
        torch.testing.assert_close(params[n].detach(), t, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(g_prog[n], seen[n], rtol=1e-3, atol=1e-8)


@pytest.mark.parametrize("seed", [1, 7])
def test_resnet_readings_agree(root, seed):
    cell = spec.load_cell("tiny-resnet.b16", root)  # f32 compute, one step (tiny.CELLS)
    session = resnet.Session(cell, seed, CPU)
    prog = session.first_steps(1)
    session.close()
    numbers = readings.compare(prog, resnet.reference(cell, seed, CPU, 1))
    for name, v in numbers.items():
        print(name, v)
    assert numbers["loss"]["value"] < 1e-5
    assert numbers["grad"]["value"] < 1e-2
    assert numbers["change"]["value"] < 1e-2
    assert numbers["stats"]["value"] < 1e-2


def test_resnet_stats_move_once_a_step(root):
    """One step moves each running statistic once, as the reference's."""
    cell = spec.load_cell("tiny-resnet.b16", root)
    session = resnet.Session(cell, 3, CPU)
    prog = session.first_steps(1)
    session.close()
    ref = resnet.reference(cell, 3, CPU, 1)
    for n in ref["stats"]:
        assert prog["stats"][n] == pytest.approx(ref["stats"][n], rel=1e-4, abs=1e-7)


def test_optimizer_follows_optax_clip_and_bf16_moment():
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([3.0, 4.0])}
    assert optim.clip_by_global_norm(g, 1.0) == 5.0
    torch.testing.assert_close(g["w"], torch.tensor([0.6, 0.8]))
    opt = {"optimizer": "adamw", "learning_rate": 0.1, "beta1": 0.9, "beta2": 0.95,
           "adam_mu_bf16": True}
    state = optim.init_state(p, opt)
    optim.update(p, g, state, 1, opt)
    # step 1: m/bc1 = g, sqrt(nu/bc2) = |g|: each weight moves by lr
    torch.testing.assert_close(p["w"], torch.tensor([0.9, -2.1]))
    assert state["mu"]["w"].dtype == torch.bfloat16


def _data_parallel_rank(local_rank, world, port, config, tokens, out):
    """Rank ``local_rank`` of the reference trained over ``world`` gloo ranks."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=local_rank,
                            world_size=world)
    try:
        w = dict(decoder.draw(config, 5, CPU))
        rows = tokens[0].shape[0] // world
        mine = [t[local_rank * rows:(local_rank + 1) * rows] for t in tokens]
        losses, scales = ref_decoder.train_data_parallel(w, mine, config)
        if local_rank == world - 1:
            torch.save({"losses": losses, "w": w}, out)
    finally:
        dist.destroy_process_group()


def test_data_parallel_reference_trains_as_on_one_process(root, tmp_path):
    """Over four ranks, each with a quarter of the rows, the reference's
    losses and weights after two steps are those of the whole batch on one
    process (the last rank holds them whole)."""
    from mpi_operator_tpu_torch.runtime import bootstrap

    cell = spec.load_cell(tiny.GANG, root)
    tokens = [torch.from_numpy(b["tokens"]).long()
              for b in traffic.pool(cell.traffic, cell.config, 5, CPU)[:2]]
    out = str(tmp_path / "w.pt")
    codes = bootstrap.run_local_ranks(_data_parallel_rank, 4,
                                      (4, bootstrap.free_port(), cell.config, tokens, out),
                                      timeout=300)
    assert codes == [0, 0, 0, 0]
    gang = torch.load(out)
    w = dict(decoder.draw(cell.config, 5, CPU))
    losses = ref_decoder.train(w, tokens, cell.config)
    assert gang["losses"] == pytest.approx(losses, rel=1e-5)
    # Adam moves an element whose gradient is all but zero by up to lr, so
    # the sums' other order shows there: 1 % of a step at lr 3e-4
    for name, t in w.items():
        torch.testing.assert_close(gang["w"][name], t, rtol=1e-5, atol=3e-6)
