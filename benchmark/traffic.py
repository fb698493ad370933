"""The one traffic generator: a pool of distinct batches drawn from the seed.

A mix (``traffic/<name>.json``) gives the kind of batch, its global size,
its shape and the size of the pool; the model's configuration gives the
vocabulary or the image size and the classes. Every batch is drawn on the
device from a ``torch.Generator`` seeded from ``--seed`` and the batch's
index, then kept in host memory, so the same seed gives the same batches
wherever they are drawn, and the window's feed pays the copy to the device
as a training job's input does. Every seed draws the same sizes: only the
values differ.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List

import numpy as np
import torch


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) of the run's ``seed``: any
    whole number, negative or beyond 64 bits, gives one."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def pool(traffic: Dict[str, Any], config: Dict[str, Any], seed: int,
         device) -> List[Dict[str, np.ndarray]]:
    """``traffic["pool"]`` host batches of ``traffic["global_batch"]`` rows:
    ``{"tokens": int32 [B, T]}`` with ids uniform over ``vocab_size``, or
    ``{"image": uint8 [B, H, W, C], "label": int32 [B]}`` with bytes and
    labels uniform, as ``ops.data``'s synthetic streams lay them out."""
    out = []
    b = int(traffic["global_batch"])
    for i in range(int(traffic["pool"])):
        g = generator(seed, f"batch{i}", device)
        if traffic["kind"] == "tokens":
            t = int(traffic["seq_len"])
            ids = torch.randint(0, int(config["vocab_size"]), (b, t), generator=g,
                                device=device, dtype=torch.int32)
            out.append({"tokens": ids.cpu().numpy()})
        elif traffic["kind"] == "images":
            s, c = int(config["image_size"]), int(config["channels"])
            img = torch.randint(0, 256, (b, s, s, c), generator=g, device=device,
                                dtype=torch.uint8)
            lab = torch.randint(0, int(config["num_classes"]), (b,), generator=g,
                                device=device, dtype=torch.int32)
            out.append({"image": img.cpu().numpy(), "label": lab.cpu().numpy()})
        else:
            raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    return out
