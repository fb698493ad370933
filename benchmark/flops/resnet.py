"""FLOPs a ResNet training step needs, from the configuration's shapes (a copy
of the port's ``models/resnet.flops_per_sample``, kept here so that the
yardstick does not move with the program). Convolutions and the head only,
2 x MACs; a step needs 3x the forward (forward, and the backward's two
products per convolution)."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


def _blocks(config: Dict[str, Any]) -> List[Tuple[int, int, int, int]]:
    """(in, mid, out, stride of the 3x3) per bottleneck block (v1.5)."""
    out, c_in, w = [], int(config["width"]), int(config["width"])
    for stage, n in enumerate(config["stage_blocks"]):
        mid = w * 2 ** stage
        for b in range(n):
            out.append((c_in, mid, mid * 4, 2 if stage > 0 and b == 0 else 1))
            c_in = mid * 4
    return out


def forward_flops_per_sample(config: Dict[str, Any]) -> float:
    h = int(config["image_size"]) // 2  # the 7x7 stem, stride 2
    total = 2.0 * 49 * int(config["channels"]) * int(config["width"]) * h * h
    h = (h + 1) // 2  # max pool, stride 2
    for c_in, mid, out, stride in _blocks(config):
        total += 2.0 * c_in * mid * h * h
        h_out = h // stride
        total += 2.0 * 9 * mid * mid * h_out * h_out
        total += 2.0 * mid * out * h_out * h_out
        if c_in != out:
            total += 2.0 * c_in * out * h_out * h_out
        h = h_out
    total += 2.0 * _blocks(config)[-1][2] * int(config["num_classes"])
    return total


def step_flops(config: Dict[str, Any], images: int) -> Dict[str, float]:
    products = 3.0 * forward_flops_per_sample(config) * images
    return {"products": products, "total": products}
