"""MNIST convnet in PyTorch.

Port of ``mpi_operator_tpu/models/mnist.py``: two 5×5 SAME convolutions,
each with ReLU and a 2×2 max-pool, then two dense layers, softmax
cross-entropy, bf16 compute with f32 parameters. It takes the NHWC batch
and views it as NCHW (channels-last memory), as models/resnet.py does;
weights are OIHW, the dense layers ``[in, out]``. The flatten before
``dense1`` is in NHWC order (the JAX package's), so one set of weights
serves both packages (``params_from_jax``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Config:
    num_classes: int = 10
    image_size: int = 28
    channels: int = 1
    hidden: int = 128
    compute_dtype: Any = torch.bfloat16


class MNIST(nn.Module):
    """images [B, H, W, C] → logits [B, classes] f32."""

    def __init__(self, config: Config, device=None):
        super().__init__()
        c = config
        self.config = c
        flat = (c.image_size // 4) ** 2 * 64
        self.conv1 = nn.Parameter(torch.empty(32, c.channels, 5, 5, device=device))
        self.conv2 = nn.Parameter(torch.empty(64, 32, 5, 5, device=device))
        self.dense1_w = nn.Parameter(torch.empty(flat, c.hidden, device=device))
        self.dense1_b = nn.Parameter(torch.zeros(c.hidden, device=device))
        self.dense2_w = nn.Parameter(torch.empty(c.hidden, c.num_classes, device=device))
        self.dense2_b = nn.Parameter(torch.zeros(c.num_classes, device=device))

    def forward(self, images):
        dt = self.config.compute_dtype
        x = images.permute(0, 3, 1, 2).to(dt)
        for w in (self.conv1, self.conv2):
            w = w.to(dtype=dt, memory_format=torch.channels_last)
            x = F.max_pool2d(F.relu(F.conv2d(x, w, padding="same")), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten, as in JAX
        x = F.relu(x @ self.dense1_w.to(dt) + self.dense1_b.to(dt))
        return (x @ self.dense2_w.to(dt) + self.dense2_b.to(dt)).float()

    # -- the sharding protocol (parallel/sharding.py) -----------------------

    def logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        return logical_axes(self.config)

    def fsdp_units(self) -> List[nn.Module]:
        return []  # the root alone

    def set_parallel(self, mesh) -> None:
        from mpi_operator_tpu_torch.runtime.topology import AXIS_DATA, AXIS_FSDP, mesh_sizes

        other = {a: s for a, s in mesh_sizes(mesh).items()
                 if s > 1 and a not in (AXIS_DATA, AXIS_FSDP)}
        if other:
            raise ValueError(f"MNIST shards over data and fsdp only, not {other}")


def init(config: Config, generator: torch.Generator,
         device: Union[str, torch.device] = "cuda") -> MNIST:
    """He-normal weights (the JAX package's fan-ins), zero biases, drawn
    from ``generator`` on ``device``."""
    model = MNIST(config, device=device)
    with torch.no_grad():
        for w in (model.conv1, model.conv2, model.dense1_w, model.dense2_w):
            fan_in = w[0].numel() if w.dim() == 4 else w.shape[0]
            w.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
    return model


def logical_axes(config: Config) -> Dict[str, Tuple[Optional[str], ...]]:
    conv = ("conv_out", "conv_in", "conv_kernel", "conv_kernel")
    return {"conv1": conv, "conv2": conv, "dense1_w": ("embed", "mlp"), "dense1_b": ("mlp",),
            "dense2_w": ("mlp", "vocab"), "dense2_b": ("vocab",)}


def apply(model: MNIST, images):
    return model(images)


def loss_fn(model: MNIST, batch: Dict[str, torch.Tensor]):
    logits = model(batch["image"])
    labels = F.one_hot(batch["label"].long(), model.config.num_classes).float()
    return -(labels * torch.log_softmax(logits, -1)).sum(-1).mean()


def flops_per_sample(config: Config) -> float:
    s = config.image_size
    c1 = 2 * 25 * config.channels * 32 * s * s
    c2 = 2 * 25 * 32 * 64 * (s // 2) ** 2
    flat = (s // 4) ** 2 * 64
    d1 = 2 * flat * config.hidden
    d2 = 2 * config.hidden * config.num_classes
    return float(c1 + c2 + d1 + d2)


def params_from_jax(params: Dict[str, Any],
                    device: Optional[Union[str, torch.device]] = None) -> Dict[str, torch.Tensor]:
    """The JAX ``init`` tree (leaves as numpy) → a state dict for :class:`MNIST`."""

    def t(a, conv=False):
        a = np.array(a)  # a writable copy
        return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1) if conv else a))

    out = {"conv1": t(params["conv1"]["w"], True), "conv2": t(params["conv2"]["w"], True)}
    for name in ("dense1", "dense2"):
        out[f"{name}_w"], out[f"{name}_b"] = t(params[name]["w"]), t(params[name]["b"])
    return {k: v.to(device) for k, v in out.items()}
