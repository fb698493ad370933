"""Input data for the Llama workload.

Port of ``synthetic_tokens`` and ``make_global_batch`` from
``mpi_operator_tpu/ops/data.py``. The token stream draws from the same
``np.random.default_rng(seed + process_index)``, so the tokens are the JAX
package's, bit for bit. Prefetch and the image pipelines come later.
"""

from __future__ import annotations

from typing import Dict, Iterator, Union

import numpy as np
import torch


def synthetic_tokens(
    *,
    global_batch: int,
    seq_len: int,
    vocab: int,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Host-local synthetic LM token stream: this host's share of every
    global batch, the same fixed int32 tokens each step."""
    local = global_batch // process_count
    rng = np.random.default_rng(seed + process_index)
    tokens = rng.integers(0, vocab, (local, seq_len)).astype(np.int32)
    while True:
        yield {"tokens": tokens}


def make_global_batch(
    host_local: Dict[str, np.ndarray], device: Union[str, torch.device]
) -> Dict[str, torch.Tensor]:
    """Place a host batch on one device. Integer arrays become int64 (the
    index type of PyTorch's gathers)."""
    out = {}
    for name, arr in host_local.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if not t.is_floating_point():
            t = t.long()
        out[name] = t.to(device)
    return out
