"""Input data for the Llama workload.

Port of ``synthetic_tokens`` and ``make_global_batch`` from
``mpi_operator_tpu/ops/data.py``. The token stream draws per host from the
same ``np.random.default_rng(seed + host)``, ``global_batch // hosts`` rows,
so the tokens are the JAX package's, bit for bit, whatever the number of
chips per host. A host's local ranks then take contiguous slices of its
batch (:func:`make_global_batch`), so the global batch is the JAX package's
row for row. Prefetch and the image pipelines come later.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from mpi_operator_tpu_torch.runtime import bootstrap


def synthetic_tokens(
    *,
    global_batch: int,
    seq_len: int,
    vocab: int,
    seed: int = 0,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Host-local synthetic LM token stream: this host's share of every
    global batch, the same fixed int32 tokens each step. The host and the
    number of hosts default to the gang's (``bootstrap.process_index`` /
    ``process_count``)."""
    if process_index is None:
        process_index = bootstrap.process_index()
    if process_count is None:
        process_count = bootstrap.process_count()
    local = global_batch // process_count
    rng = np.random.default_rng(seed + process_index)
    tokens = rng.integers(0, vocab, (local, seq_len)).astype(np.int32)
    while True:
        yield {"tokens": tokens}


def make_global_batch(
    host_local: Dict[str, np.ndarray], device: Union[str, torch.device], mesh=None
) -> Dict[str, torch.Tensor]:
    """This rank's part of a host batch, on its device. Without a mesh, the
    whole host batch; with one, local rank i of L takes rows [i·n/L,
    (i+1)·n/L) (the batch is sharded over the mesh's data and fsdp axes,
    the only ones the port shards over). Integer arrays become int64 (the
    index type of PyTorch's gathers)."""
    i, n_local = (bootstrap.local_rank(), bootstrap.local_chips()) if mesh is not None else (0, 1)
    out = {}
    for name, arr in host_local.items():
        rows = arr.shape[0]
        if rows % n_local:
            raise ValueError(f"a host batch of {rows} rows does not split over {n_local} ranks")
        arr = arr[i * rows // n_local:(i + 1) * rows // n_local]
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if not t.is_floating_point():
            t = t.long()
        out[name] = t.to(device)
    return out
