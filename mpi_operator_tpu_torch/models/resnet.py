"""ResNet v1.5 (26/50/101) in PyTorch: the image workload.

Port of ``mpi_operator_tpu/models/resnet.py``: the same config fields,
block layout, init distribution and arithmetic, as an ``nn.Module`` whose
batch-norm running statistics are buffers, updated in place by the
training forward (the JAX package threads them as ``model_state``).

Layout: the model takes the JAX package's NHWC image batch and views it as
NCHW (``permute(0, 3, 1, 2)``, no copy), which is ``torch.channels_last``
memory, the layout cuDNN's convolutions run fastest in; every activation
stays channels-last. Convolution weights are OIHW (the JAX HWIO weights
``transpose(3, 2, 0, 1)``), cast to the compute dtype in channels-last
memory at each use. The stem is the plain 7×7/s2 convolution with padding
3: the JAX package's space-to-depth 4×4 stem is a TPU rewrite of the same
function (its odd image sizes run this one).

Batch norm is the JAX package's, not ``nn.BatchNorm2d``'s:

- one-pass f32 statistics, ``var = max(E[x²] − E[x]², 0)``;
- the running var is the biased one, ``mom·s + (1 − mom)·stat``;
- the normalize is ``x·inv + offset`` in the compute dtype, with
  ``inv = rsqrt(var + eps)·scale`` and ``offset = bias − mean·inv`` in f32.

Over a mesh the statistics are global, as under the JAX package's sharded
jit: the f32 sums of x and x² are all-reduced over the batch ranks
(``set_parallel``) with a differentiable all-reduce, so the backward is the
global batch's too. The eval forward (``model.eval()``) normalizes with the
running statistics and leaves them as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

STAGE_BLOCKS = {
    "resnet26": (2, 2, 2, 2),  # test-scale: same bottleneck topology
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}


@dataclasses.dataclass(frozen=True)
class Config:
    depth: str = "resnet101"
    num_classes: int = 1000
    image_size: int = 224
    channels: int = 3
    width: int = 64
    compute_dtype: Any = torch.bfloat16
    bn_momentum: float = 0.9
    bn_epsilon: float = 1e-5

    @property
    def stage_blocks(self) -> Tuple[int, ...]:
        return STAGE_BLOCKS[self.depth]


def _block_channels(config: Config) -> List[Tuple[int, int, int]]:
    """(in, mid, out) per block, flattened over stages."""
    chans = []
    w = config.width
    c_in = w
    for stage, n_blocks in enumerate(config.stage_blocks):
        mid = w * 2 ** stage
        out = mid * 4
        for _ in range(n_blocks):
            chans.append((c_in, mid, out))
            c_in = out
    return chans


def _strides(config: Config) -> List[int]:
    """The 3×3 convolution's stride per block (v1.5: the first block of
    every stage after the first halves the map)."""
    return [2 if (stage > 0 and b == 0) else 1
            for stage, n in enumerate(config.stage_blocks) for b in range(n)]


class BatchNorm(nn.Module):
    """The JAX package's batch norm over dim 1 of an NCHW tensor (module
    docstring); ``group``: the batch ranks its statistics are global over."""

    def __init__(self, channels: int, config: Config, device=None):
        super().__init__()
        self.momentum, self.eps = config.bn_momentum, config.bn_epsilon
        self.group = None
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def _batch_stats(self, x):
        x32 = x.float()
        sums = torch.stack([x32.sum((0, 2, 3)), x32.square().sum((0, 2, 3))])
        n = x.numel() // x.shape[1]
        if self.group is not None:
            from torch.distributed.nn.functional import all_reduce

            sums = all_reduce(sums, group=self.group)
            n *= torch.distributed.get_world_size(self.group)
        mean, mean2 = sums[0] / n, sums[1] / n
        return mean, torch.clamp_min(mean2 - mean.square(), 0.0)

    def forward(self, x):
        if self.training:
            mean, var = self._batch_stats(x)
            with torch.no_grad():
                mom = self.momentum
                self.mean.copy_(mom * self.mean + (1 - mom) * mean)
                self.var.copy_(mom * self.var + (1 - mom) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        offset = self.bias - mean * inv
        dt = x.dtype
        return x * inv.to(dt)[:, None, None] + offset.to(dt)[:, None, None]


def _conv(x, w, stride: int = 1):
    """A square convolution with the JAX package's ``k // 2`` padding, its
    weight cast to the activations' dtype in channels-last memory."""
    w = w.to(dtype=x.dtype, memory_format=torch.channels_last)
    return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)


def _he(generator, shape, device):
    """He-normal OIHW weight (or [in, out] matrix) from ``generator``."""
    fan_in = shape[1] * shape[2] * shape[3] if len(shape) == 4 else shape[0]
    w = torch.empty(*shape, device=device)
    return w.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (strided) → 1×1, each with batch norm; a projection
    shortcut where the channels change."""

    def __init__(self, c_in: int, mid: int, out: int, stride: int, config: Config, device=None):
        super().__init__()
        self.stride = stride

        def conv(o, i, k):
            return nn.Parameter(torch.empty(o, i, k, k, device=device))

        self.conv1, self.bn1 = conv(mid, c_in, 1), BatchNorm(mid, config, device)
        self.conv2, self.bn2 = conv(mid, mid, 3), BatchNorm(mid, config, device)
        self.conv3, self.bn3 = conv(out, mid, 1), BatchNorm(out, config, device)
        self.proj = self.proj_bn = None
        if c_in != out:
            self.proj, self.proj_bn = conv(out, c_in, 1), BatchNorm(out, config, device)

    def forward(self, x):
        y = F.relu(self.bn1(_conv(x, self.conv1)))
        y = F.relu(self.bn2(_conv(y, self.conv2, self.stride)))
        y = self.bn3(_conv(y, self.conv3))
        shortcut = x
        if self.proj is not None:
            shortcut = self.proj_bn(_conv(x, self.proj, self.stride))
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    """images [B, H, W, C] (NHWC, any dtype) → logits [B, classes] f32."""

    def __init__(self, config: Config, device=None):
        super().__init__()
        c = config
        self.config = c
        self.stem = nn.Parameter(torch.empty(c.width, c.channels, 7, 7, device=device))
        self.stem_bn = BatchNorm(c.width, c, device)
        self.blocks = nn.ModuleList(
            Bottleneck(ci, mid, out, s, c, device)
            for (ci, mid, out), s in zip(_block_channels(c), _strides(c)))
        final = _block_channels(c)[-1][2]
        self.head_w = nn.Parameter(torch.empty(final, c.num_classes, device=device))
        self.head_b = nn.Parameter(torch.zeros(c.num_classes, device=device))

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).to(self.config.compute_dtype)  # channels-last NCHW
        x = F.relu(self.stem_bn(_conv(x, self.stem, 2)))
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        x = x.float().mean((2, 3))
        return x @ self.head_w + self.head_b

    # -- the sharding protocol (parallel/sharding.py) -----------------------

    def logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        return logical_axes(self.config)

    def fsdp_units(self) -> List[nn.Module]:
        """FSDP2's units below the root: one per bottleneck block."""
        return list(self.blocks)

    def set_parallel(self, mesh) -> None:
        """Global batch norm over the batch ranks. Only ``data`` and
        ``fsdp`` shard a ResNet; it runs no tensor or sequence split."""
        import torch.distributed as dist

        from mpi_operator_tpu_torch.runtime.topology import AXIS_DATA, AXIS_FSDP, mesh_sizes

        other = {a: s for a, s in mesh_sizes(mesh).items()
                 if s > 1 and a not in (AXIS_DATA, AXIS_FSDP)}
        if other:
            raise ValueError(f"a ResNet shards over data and fsdp only, not {other}")
        group = dist.group.WORLD if dist.get_world_size() > 1 else None
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = group


def init(config: Config, generator: torch.Generator,
         device: Union[str, torch.device] = "cuda") -> ResNet:
    """A model with the JAX package's init distribution (He-normal convs and
    head, unit BN scales, zero biases, running stats 0 / 1), drawn from
    ``generator``, which must live on ``device``."""
    model = ResNet(config, device=device)
    with torch.no_grad():
        model.stem.copy_(_he(generator, model.stem.shape, device))
        for block in model.blocks:
            for name in ("conv1", "conv2", "conv3", "proj"):
                p = getattr(block, name)
                if p is not None:
                    p.copy_(_he(generator, p.shape, device))
        model.head_w.copy_(_he(generator, model.head_w.shape, device))
    return model


def logical_axes(config: Config) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes of every parameter, keyed by its state-dict name (the
    JAX package's, with the conv weights' axes in OIHW order)."""
    conv = ("conv_out", "conv_in", "conv_kernel", "conv_kernel")
    stats = ("stats",)
    axes = {"stem": conv, "stem_bn.scale": stats, "stem_bn.bias": stats,
            "head_w": ("embed", "vocab"), "head_b": ("vocab",)}
    for i, (c_in, _, out) in enumerate(_block_channels(config)):
        names = ["1", "2", "3"] + (["proj"] if c_in != out else [])
        for n in names:
            conv_name, bn = (f"conv{n}", f"bn{n}") if n != "proj" else ("proj", "proj_bn")
            axes[f"blocks.{i}.{conv_name}"] = conv
            axes[f"blocks.{i}.{bn}.scale"] = stats
            axes[f"blocks.{i}.{bn}.bias"] = stats
    return axes


def apply(model: ResNet, images):
    """images [B,H,W,C] → logits [B, classes] f32 (train or eval per the
    module's mode)."""
    return model(images)


def loss_fn(model: ResNet, batch: Dict[str, torch.Tensor]):
    """Mean softmax cross-entropy of one-hot labels."""
    logits = model(batch["image"])
    labels = F.one_hot(batch["label"].long(), model.config.num_classes).float()
    return -(labels * torch.log_softmax(logits, -1)).sum(-1).mean()


def flops_per_sample(config: Config) -> float:
    """Analytic forward-pass matmul/conv FLOPs per image (2·MACs)."""
    size = config.image_size
    total = 0.0
    h = size // 2  # stem stride 2
    total += 2 * 49 * config.channels * config.width * h * h
    h = (h + 1) // 2  # maxpool stride 2
    for (c_in, mid, out), stride in zip(_block_channels(config), _strides(config)):
        total += 2 * c_in * mid * h * h  # 1x1
        h_out = h // stride
        total += 2 * 9 * mid * mid * h_out * h_out  # 3x3 (strided)
        total += 2 * mid * out * h_out * h_out  # 1x1
        if c_in != out:
            total += 2 * c_in * out * h_out * h_out
        h = h_out
    total += 2 * _block_channels(config)[-1][2] * config.num_classes
    return float(total)


def _oihw(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def params_from_jax(params: Dict[str, Any], state: Dict[str, Any],
                    device: Optional[Union[str, torch.device]] = None) -> Dict[str, torch.Tensor]:
    """The JAX ``init`` trees (params and BN state, leaves as numpy) → a
    state dict for :class:`ResNet`, buffers included
    (``model.load_state_dict(params_from_jax(params, state))``)."""

    def vec(a):
        return torch.from_numpy(np.array(a))

    def bn(prefix, p, s):
        return {f"{prefix}.scale": vec(p["scale"]), f"{prefix}.bias": vec(p["bias"]),
                f"{prefix}.mean": vec(s["mean"]), f"{prefix}.var": vec(s["var"])}

    out = {"stem": _oihw(params["stem"]["w"]), "head_w": vec(params["head"]["w"]),
           "head_b": vec(params["head"]["b"])}
    out.update(bn("stem_bn", params["stem_bn"], state["stem_bn"]))
    i = 0
    while f"block{i}" in params:
        blk, sblk = params[f"block{i}"], state[f"block{i}"]
        for n in ("1", "2", "3"):
            out[f"blocks.{i}.conv{n}"] = _oihw(blk[f"conv{n}"]["w"])
            out.update(bn(f"blocks.{i}.bn{n}", blk[f"bn{n}"], sblk[f"bn{n}"]))
        if "proj" in blk:
            out[f"blocks.{i}.proj"] = _oihw(blk["proj"]["w"])
            out.update(bn(f"blocks.{i}.proj_bn", blk["proj_bn"], sblk["proj_bn"]))
        i += 1
    return {k: v.to(device) for k, v in out.items()}
