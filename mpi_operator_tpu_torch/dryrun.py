"""Multi-device dry run of the full training step on a data×fsdp×tensor×
sequence mesh, then the expert- and pipeline-parallel layers.

Port of ``dryrun_multichip`` and ``_dryrun_inprocess`` in the repository's
``__graft_entry__.py``: :func:`_plan_for` factors n devices into the same
mesh (8 → ``fsdp=2,tensor=2,sequence=2``), one step of ``tiny()`` runs on
it at the JAX dry run's shapes (batch max(8, n), seq 16 × sequence), then
the DCN step: two slices on the ``data`` axis's slice factor
(``_dryrun_multislice``); then EP (``_dryrun_expert_parallel``: the MoE
layer with its n experts over ``expert=n``) and PP
(``_dryrun_pipeline_parallel``: the GPipe schedule over ``pipe`` = 4, or
2, beside ``data``). Each of the last two is also held to its local form
(all experts here; the layers in order), within 1e-5 relative.

Every rank is a fresh process, spawned as the worker spawns its ranks
(``runtime/bootstrap.run_local_ranks``; gloo or NCCL rendezvous at a free
localhost port): one per card on CUDA, the default; ``device="cpu"`` runs n gloo
ranks on the CPU. ``tiny()`` runs as it is (head_dim 16) on either.

    python -m mpi_operator_tpu_torch.dryrun [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from mpi_operator_tpu_torch.runtime.topology import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPE,
    AXIS_SEQ,
    AXIS_TENSOR,
    MeshPlan,
)

TOL_LOCAL = 1e-5  # the EP and PP layers against their local forms

def _plan_for(n_devices: int) -> MeshPlan:
    """Factor n into a full dp×fsdp×tensor×sequence mesh (largest factors on
    the parallelism axes that exercise the most collectives)."""
    order = [AXIS_FSDP, AXIS_TENSOR, AXIS_SEQ, AXIS_DATA]
    sizes = {a: 1 for a in order}
    rem = n_devices
    i = 0
    while rem % 2 == 0 and rem > 1:
        sizes[order[i % len(order)]] *= 2
        rem //= 2
        i += 1
    if rem > 1:  # odd remainder rides the data axis
        sizes[AXIS_DATA] *= rem
    return MeshPlan(axes={a: s for a, s in sizes.items() if s > 1} or {AXIS_DATA: 1})


def dryrun_multichip(n_devices: int = 8, device: Optional[str] = None, timeout: float = 600):
    """Run the dry run on ``n_devices`` ranks, each a fresh process, and
    raise ``RuntimeError`` when any of them fails (its traceback is on
    stderr). Returns rank 0's record (its losses and meshes). CUDA by
    default (needs n cards); ``"cpu"`` for gloo ranks."""
    from mpi_operator_tpu_torch.runtime import bootstrap

    dev = bootstrap.resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} ranks need {n_devices} cards; "
                           f"{torch.cuda.device_count()} are visible")
    env = {bootstrap.ENV_NUM_HOSTS: "1", bootstrap.ENV_HOST_ID: "0",
           bootstrap.ENV_CHIPS_PER_HOST: str(n_devices),
           bootstrap.ENV_COORDINATOR: f"127.0.0.1:{bootstrap.free_port()}"}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        codes = bootstrap.run_local_ranks(_rank_main, n_devices,
                                          (n_devices, dev.type, env, out), timeout=timeout)
        failed = [(r, c) for r, c in enumerate(codes) if c != 0]
        if failed:
            raise RuntimeError(f"multichip dryrun rank {failed[0][0]} failed "
                               f"(rc={failed[0][1]}); its traceback is on stderr")
        with open(out) as f:
            return json.load(f)


def _rank_main(local_rank: int, n_devices: int, device: str, environ: dict, out: str) -> None:
    """One rank of :func:`dryrun_multichip`; rank 0 writes the record to
    ``out``."""
    os.environ.update(environ)
    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    record = _dryrun_inprocess(n_devices, device, local_rank)
    if local_rank == 0:
        with open(out, "w") as f:
            json.dump(record, f)


def _step(mesh, device, plan: MeshPlan, batch_sz: int, seq_len: int) -> float:
    """One train step of tiny() on ``mesh``; returns the loss."""
    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.data import make_global_batch

    cfg = llama.tiny()
    model = llama.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    trainer = Trainer(llama.loss_fn, TrainerConfig(learning_rate=1e-3), mesh=mesh)
    state = trainer.init_state(model)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (batch_sz, seq_len)).astype(np.int32)
    state, metrics = trainer.train_step(state, make_global_batch({"tokens": tokens}, device, mesh))
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss} on {dict(plan.ordered())}")
    return loss


def _dryrun_inprocess(n_devices: int, device: str, local_rank: int) -> dict:
    import torch.distributed as dist

    from mpi_operator_tpu_torch.runtime import bootstrap
    from mpi_operator_tpu_torch.runtime.topology import build_mesh, mesh_from_context

    ctx = bootstrap.context_from_env()
    dev = bootstrap.initialize(ctx, device=device, local_rank=local_rank, group=True)
    try:
        plan = _plan_for(n_devices)
        mesh = mesh_from_context(ctx, plan, dev.type)
        seq_len = 16 * plan.axes.get(AXIS_SEQ, 1)
        batch_sz = max(8, plan.total_devices)
        loss = _step(mesh, dev, plan, batch_sz, seq_len)
        log = dist.get_rank() == 0
        if log:
            print(f"[dryrun] mesh: {dict(plan.ordered())}", file=sys.stderr)
            print(f"[dryrun] OK: {n_devices} devices, loss={loss:.4f}", file=sys.stderr)
        record = {"mesh": dict(plan.ordered()), "loss": loss, "batch": batch_sz,
                  "seq_len": seq_len}
        if n_devices % 2 == 0:  # DCN: 2 slices on the data axis's slice factor
            dcn = MeshPlan(axes={AXIS_DATA: 1, AXIS_FSDP: n_devices // 2}, dcn={AXIS_DATA: 2})
            record["dcn_loss"] = _step(build_mesh(dcn, dev.type), dev, dcn, 8, 16)
            if log:
                print(f"[dryrun] DCN OK: 2 slices x {n_devices // 2} devices, "
                      f"loss={record['dcn_loss']:.4f}", file=sys.stderr)
        record.update(_dryrun_expert_parallel(n_devices, dev, log))
        record.update(_dryrun_pipeline_parallel(n_devices, dev, log))
        return record
    finally:
        bootstrap.shutdown()


def _rel_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _dryrun_expert_parallel(n_devices: int, dev: torch.device, log: bool) -> dict:
    """EP: the MoE layer with its experts over ``expert=n``, against all
    experts run on this rank."""
    from mpi_operator_tpu_torch.parallel import moe
    from mpi_operator_tpu_torch.runtime.topology import build_mesh

    mesh = build_mesh(MeshPlan(axes={AXIS_EXPERT: n_devices}), dev.type)
    cfg = moe.MoEConfig(d_model=32, d_ff=64, n_experts=n_devices)
    params = moe.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    x = torch.randn(2, 16, 32, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    y, aux = moe.apply(cfg, params, x, mesh=mesh)
    y_local, aux_local = moe.apply(cfg, params, x)
    diff = _rel_diff(y, y_local)
    if not (y.shape == x.shape and math.isfinite(float(aux)) and diff <= TOL_LOCAL
            and abs(float(aux) - float(aux_local)) <= TOL_LOCAL * float(aux_local)):
        raise AssertionError(f"EP: y {tuple(y.shape)} off its local form by {diff}, "
                             f"aux {float(aux)} vs {float(aux_local)}")
    if log:
        print(f"[dryrun] EP OK: {n_devices}-way experts, aux={float(aux):.3f}", file=sys.stderr)
    return {"ep_experts": n_devices, "ep_aux": float(aux), "ep_diff": diff}


def _dryrun_pipeline_parallel(n_devices: int, dev: torch.device, log: bool) -> dict:
    """PP: the GPipe schedule over ``pipe`` (4 stages where n divides by 4,
    else 2, else none) with ``data`` beside it, against the layers in
    order."""
    from mpi_operator_tpu_torch.parallel.pipeline import run_pipeline
    from mpi_operator_tpu_torch.runtime.topology import build_mesh

    pipe = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    if pipe == 1:
        return {}
    mesh = build_mesh(MeshPlan(axes={AXIS_DATA: n_devices // pipe, AXIS_PIPE: pipe}), dev.type)
    d, n_layers = 16, pipe * 2
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"w": torch.randn(n_layers, d, d, generator=gen, device=dev) * 0.5,
              "b": torch.zeros(n_layers, d, device=dev)}
    x = torch.randn(8, d, generator=gen, device=dev)

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    y = run_pipeline(stage, params, x, mesh, n_microbatches=4)
    diff = _rel_diff(y, run_pipeline(stage, params, x, None, n_microbatches=4))
    if not (y.shape == x.shape and bool(torch.isfinite(y).all()) and diff <= TOL_LOCAL):
        raise AssertionError(f"PP: y {tuple(y.shape)} off the layers in order by {diff}")
    if log:
        print(f"[dryrun] PP OK: {pipe}-stage pipeline", file=sys.stderr)
    return {"pp_stages": pipe, "pp_diff": diff}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu: gloo ranks on the CPU (default: cuda, one rank per card)")
    a = ap.parse_args()
    print(json.dumps(dryrun_multichip(a.n_devices, a.device)))
