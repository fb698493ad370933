"""A plain float32 ResNet v1.5 and its training step.

ResNet v1.5 as tf_cnn_benchmarks builds it: a 7x7 stride-2 stem with batch
norm and ReLU, a 3x3 stride-2 max pool, bottleneck blocks (1x1, 3x3 carrying
the stage's stride, 1x1 at four times the width, each with batch norm; a
1x1 projection with batch norm where the channels change), global average
pooling and a dense head, softmax cross-entropy averaged over the batch.
Convolutions pad by ``k // 2``. The input is uint8 NHWC, normalised by the
ImageNet mean and standard deviation in the 0-255 range.

Batch norm is the configuration's: statistics over the batch and the map in
one pass, ``var = max(E[x^2] - E[x]^2, 0)``; the running statistics
``m * running + (1 - m) * batch`` (the biased variance); the output
``x * inv + (bias - mean * inv)`` with ``inv = rsqrt(var + eps) * scale``.

It fits a card by blocks: the forward keeps each block's input and updates
the running statistics once; the backward runs each block again with
autograd (leaving the statistics alone) before its own backward.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import optim

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def blocks(config: Dict[str, Any]) -> List[Tuple[int, int, int, int]]:
    """(in, mid, out, stride of the 3x3) per bottleneck block."""
    out, c_in, w = [], int(config["width"]), int(config["width"])
    for stage, n in enumerate(config["stage_blocks"]):
        mid = w * 2 ** stage
        for b in range(n):
            out.append((c_in, mid, mid * 4, 2 if stage > 0 and b == 0 else 1))
            c_in = mid * 4
    return out


class Net:
    """The forward pieces over a dict of float32 leaves ``w`` (parameters) and
    ``stats`` (running statistics), both keyed by the benchmark's names."""

    def __init__(self, config: Dict[str, Any]):
        a = config["assumed"]
        self.momentum, self.eps = float(a["bn_momentum"]), float(a["bn_epsilon"])
        self.blocks = blocks(config)

    def conv(self, x, w, stride: int = 1):
        return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)

    def bn(self, x, w, stats, name: str, update: bool):
        n = x.numel() // x.shape[1]
        mean = x.sum((0, 2, 3)) / n
        var = torch.clamp_min(x.square().sum((0, 2, 3)) / n - mean.square(), 0.0)
        if update:
            with torch.no_grad():
                for key, batch in (("mean", mean), ("var", var)):
                    run = stats[f"{name}.{key}"]
                    run.copy_(self.momentum * run + (1 - self.momentum) * batch)
        inv = torch.rsqrt(var + self.eps) * w[f"{name}.scale"]
        offset = w[f"{name}.bias"] - mean * inv
        return x * inv[:, None, None] + offset[:, None, None]

    def stem(self, x, w, stats, update: bool):
        x = F.relu(self.bn(self.conv(x, w["stem"], 2), w, stats, "stem_bn", update))
        return F.max_pool2d(x, 3, 2, 1)

    def block(self, i: int, x, w, stats, update: bool):
        c_in, _, out, stride = self.blocks[i]
        p = f"blocks.{i}"
        y = F.relu(self.bn(self.conv(x, w[f"{p}.conv1"]), w, stats, f"{p}.bn1", update))
        y = F.relu(self.bn(self.conv(y, w[f"{p}.conv2"], stride), w, stats, f"{p}.bn2", update))
        y = self.bn(self.conv(y, w[f"{p}.conv3"]), w, stats, f"{p}.bn3", update)
        if c_in != out:
            x = self.bn(self.conv(x, w[f"{p}.proj"], stride), w, stats, f"{p}.proj_bn", update)
        return F.relu(y + x)

    def head_loss(self, x, w, labels):
        logits = x.mean((2, 3)) @ w["head_w"] + w["head_b"]
        return -torch.log_softmax(logits, -1).gather(-1, labels[:, None]).mean()


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, C] -> float32 [B, C, H, W], ImageNet-normalised."""
    x = images.float().permute(0, 3, 1, 2)
    mean = torch.tensor(MEAN, device=x.device)[:, None, None] * 255.0
    std = torch.tensor(STD, device=x.device)[:, None, None] * 255.0
    return ((x - mean) / std).contiguous()


def loss_and_grads(net: Net, w, stats, images, labels):
    """(loss, gradients by leaf name) of one batch; updates ``stats`` once."""
    stages: List[Callable] = [lambda x, ww, upd: net.stem(x, ww, stats, upd)]
    stages += [lambda x, ww, upd, i=i: net.block(i, x, ww, stats, upd)
               for i in range(len(net.blocks))]
    inputs: List[Optional[torch.Tensor]] = []
    with torch.no_grad():
        x = normalize(images)
        for stage in stages:
            inputs.append(x)
            x = stage(x, w, True)
    grads = {n: torch.zeros_like(t) for n, t in w.items()}
    leaves = {n: t.detach().requires_grad_() for n, t in w.items()}
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        loss = net.head_loss(x, leaves, labels)
        loss.backward()
    gx = x.grad
    for k in reversed(range(len(stages))):
        xi = inputs[k]
        inputs[k] = None
        if k:
            xi.requires_grad_()
        with torch.enable_grad():
            out = stages[k](xi, leaves, False)
            out.backward(gx)
        gx = xi.grad if k else None
        del out, xi
    for n, t in leaves.items():
        if t.grad is not None:
            grads[n] = t.grad
    return float(loss.detach()), grads


def train(w: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
          batches: List[Dict[str, torch.Tensor]], config: Dict[str, Any],
          on_grads: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
          after_step: Optional[Callable[[int], None]] = None) -> List[float]:
    """Train ``w`` and ``stats`` (float32, in place) one step per batch
    (``image`` uint8 NHWC, ``label``) with the configuration's optimizer;
    returns each step's loss. ``on_grads(step, grads)`` sees each step's
    gradients as the optimizer gets them, ``after_step(step)`` runs after
    each step's update."""
    net = Net(config)
    opt = config["assumed"]
    state = optim.init_state(w, opt)
    losses = []
    for step, batch in enumerate(batches, start=1):
        loss, grads = loss_and_grads(net, w, stats, batch["image"], batch["label"].long())
        if float(opt.get("grad_clip_norm", 0.0)) > 0:
            optim.clip_by_global_norm(grads, float(opt["grad_clip_norm"]))
        if on_grads is not None:
            on_grads(step, grads)
        optim.update(w, grads, state, step, opt)
        losses.append(loss)
        if after_step is not None:
            after_step(step)
    return losses
