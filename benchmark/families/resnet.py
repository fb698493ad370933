"""The ResNet family: ResNet v1.5 run through the port's ``models.resnet`` and
trained by ``ops.trainer.Trainer`` with momentum SGD.

The benchmark draws the weights on the card from the seed and copies them
into the program's model; the reference gets the same draw. The traffic's
pool of uint8 batches streams through ``ops.data.prefetch`` (depth from the
traffic file) with ``imagenet_normalize`` on the card; each step takes the
next batch and calls ``Trainer.train_step``. The host time blocked in the
prefetch iterator is kept per step.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from benchmark import readings, traffic
from benchmark.reference import exact
from benchmark.reference import resnet as ref_resnet

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaves(config: Dict[str, Any]):
    """(name, shape, init) of every parameter, in the order they are drawn:
    init is ``he`` (normal with std sqrt(2 / fan_in)), ``ones`` or ``zeros``."""
    w, ch = int(config["width"]), int(config["channels"])
    out = [("stem", (w, ch, 7, 7), "he"), ("stem_bn.scale", (w,), "ones"),
           ("stem_bn.bias", (w,), "zeros")]
    for i, (c_in, mid, c_out, _) in enumerate(ref_resnet.blocks(config)):
        p = f"blocks.{i}."
        convs = [("conv1", "bn1", (mid, c_in, 1, 1)), ("conv2", "bn2", (mid, mid, 3, 3)),
                 ("conv3", "bn3", (c_out, mid, 1, 1))]
        if c_in != c_out:
            convs.append(("proj", "proj_bn", (c_out, c_in, 1, 1)))
        for conv, bn, shape in convs:
            out += [(p + conv, shape, "he"), (p + bn + ".scale", (shape[0],), "ones"),
                    (p + bn + ".bias", (shape[0],), "zeros")]
    final = ref_resnet.blocks(config)[-1][2]
    out += [("head_w", (final, int(config["num_classes"])), "he"),
            ("head_b", (int(config["num_classes"]),), "zeros")]
    return out


def stats_leaves(config: Dict[str, Any]):
    """(name, shape, init) of the running statistics: mean 0, var 1."""
    out = []
    for name, shape, _ in leaves(config):
        if name.endswith(".scale"):
            bn = name[:-len(".scale")]
            out += [(bn + ".mean", shape, "zeros"), (bn + ".var", shape, "ones")]
    return out


def _fill(spec, g, device) -> Iterator[Tuple[str, torch.Tensor]]:
    for name, shape, init in spec:
        if init == "he":
            fan_in = shape[1] * shape[2] * shape[3] if len(shape) == 4 else shape[0]
            t = torch.empty(shape, device=device).normal_(0.0, (2.0 / fan_in) ** 0.5,
                                                          generator=g)
        else:
            t = (torch.ones if init == "ones" else torch.zeros)(shape, device=device)
        yield name, t


def draw(config: Dict[str, Any], seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """The float32 parameters, one leaf at a time, from one generator on ``device``."""
    return _fill(leaves(config), traffic.generator(seed, "weights", device), device)


def initial_stats(config: Dict[str, Any], device) -> Iterator[Tuple[str, torch.Tensor]]:
    return _fill(stats_leaves(config), None, device)


def model_config(config: Dict[str, Any]):
    from mpi_operator_tpu_torch.models import resnet

    a = config["assumed"]
    depth = config["depth"]
    if list(resnet.STAGE_BLOCKS[depth]) != list(config["stage_blocks"]):
        raise ValueError(f"{depth}: the port's blocks {resnet.STAGE_BLOCKS[depth]} are not "
                         f"the configuration's {config['stage_blocks']}")
    return resnet.Config(depth=depth, num_classes=int(config["num_classes"]),
                         image_size=int(config["image_size"]),
                         channels=int(config["channels"]), width=int(config["width"]),
                         compute_dtype=DTYPES[a["compute_dtype"]],
                         bn_momentum=float(a["bn_momentum"]), bn_epsilon=float(a["bn_epsilon"]))


def trainer_config(config: Dict[str, Any]):
    from mpi_operator_tpu_torch.ops.trainer import TrainerConfig

    a = config["assumed"]
    return TrainerConfig(learning_rate=float(a["learning_rate"]), optimizer=a["optimizer"],
                         momentum=float(a["momentum"]),
                         grad_clip_norm=float(a["grad_clip_norm"]))


def peak_key(config: Dict[str, Any]) -> str:
    """The peak a step's share is taken of: the configuration's precision."""
    return "fp32_flops" if config["assumed"]["compute_dtype"] == "float32" else "bf16_flops"


class Session:
    """The program's training step on one card, fed by ``ops.data.prefetch``.
    Float32 runs with TF32 off, as the configuration states it (PyTorch's
    switches for cuDNN and cuBLAS, process-wide); ``precision="tf32"`` turns
    it on: the control of a float32 configuration."""

    unit = "images"  # what a step trains

    def __init__(self, cell, seed: int, device, mesh=None, precision: Optional[str] = None):
        from mpi_operator_tpu_torch.models import resnet
        from mpi_operator_tpu_torch.ops import data
        from mpi_operator_tpu_torch.ops.trainer import Trainer

        if mesh is not None:
            raise ValueError("the ResNet family runs on one card")
        if precision not in (None, "tf32"):
            raise ValueError(f"precision {precision!r}: the port's ResNet has tf32 only")
        tf32 = precision == "tf32"
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        self.config, self.seed, self.device = cell.config, seed, device
        model = resnet.ResNet(model_config(cell.config), device=device)
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, t in draw(cell.config, seed, device):
                params[name].copy_(t)
        self.trainer = Trainer(resnet.loss_fn, trainer_config(cell.config))
        self.state = self.trainer.init_state(model)
        tr = cell.traffic
        pool = traffic.pool(tr, cell.config, seed, device)
        self.batches = data.prefetch(itertools.cycle(pool), device,
                                     depth=int(tr["prefetch_depth"]),
                                     device_transform=data.imagenet_normalize())
        self.units_per_step = int(tr["global_batch"])
        self.metrics: Dict[str, torch.Tensor] = {}
        self.input_wait_s = []

    def step(self) -> None:
        t0 = time.perf_counter()
        batch = next(self.batches)
        self.input_wait_s.append(time.perf_counter() - t0)
        self.state, self.metrics = self.trainer.train_step(self.state, batch)

    def first_steps(self, n: int) -> dict:
        """Steps 1..n, and the program's readings of them: the change and
        the statistics after the first step and after the last."""
        out = {"losses": []}
        for k in range(1, n + 1):
            self.step()
            out["losses"].append(float(self.metrics["loss"]))
            if k == 1:
                out["grad"] = readings.first_grad_norms(self.state.opt_state,
                                                        self.config["assumed"])
                out["change_first"], out["stats_first"] = self._moved()
        out["change"], out["stats"] = self._moved()
        self.input_wait_s.clear()  # the window's steps only
        return out

    def _moved(self):
        model = self.state.params
        return (readings.change_norms(dict(model.named_parameters()),
                                      draw(self.config, self.seed, self.device)),
                readings.change_norms(dict(model.named_buffers()),
                                      initial_stats(self.config, self.device)))

    def close(self) -> None:
        if self.batches is not None:
            self.batches.close()  # stops the producer thread and frees its buffers
        self.batches = self.state = self.trainer = self.metrics = None


def reference(cell, seed: int, device, steps: int) -> dict:
    """The reference's readings of the first ``steps`` steps."""
    w = dict(draw(cell.config, seed, device))
    stats = dict(initial_stats(cell.config, device))
    batches = [{"image": torch.from_numpy(b["image"]).to(device),
                "label": torch.from_numpy(b["label"]).to(device)}
               for b in traffic.pool(cell.traffic, cell.config, seed, device)[:steps]]
    out = {}

    def on_grads(step, grads):
        if step == 1:
            out["grad"] = {n: readings.norm(g) for n, g in grads.items()}

    def moved(step):
        change = readings.change_norms(w, draw(cell.config, seed, device))
        moved_stats = readings.change_norms(stats, initial_stats(cell.config, device))
        if step == 1:
            out["change_first"], out["stats_first"] = change, moved_stats
        if step == steps:
            out["change"], out["stats"] = change, moved_stats

    with exact():
        out["losses"] = ref_resnet.train(w, stats, batches, cell.config, on_grads, moved)
    return out


def control(cell, seed: int, device, steps: int, mesh=None) -> dict:
    """The control's readings: a float32 configuration (TF32 off) in the
    precision below it, the program with TF32 on, its own path."""
    if cell.config["assumed"]["compute_dtype"] != "float32":
        raise ValueError("the ResNet family has a control for float32 configurations only")
    session = Session(cell, seed, device, mesh=mesh, precision="tf32")
    try:
        return session.first_steps(steps)
    finally:
        session.close()
