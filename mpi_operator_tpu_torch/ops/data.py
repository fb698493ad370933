"""Input data for the Llama workload.

Port of ``synthetic_tokens`` and ``make_global_batch`` from
``mpi_operator_tpu/ops/data.py``. The token stream draws per host from the
same ``np.random.default_rng(seed + host)``, ``global_batch // hosts`` rows,
so the tokens are the JAX package's, bit for bit, whatever the number of
chips per host. A host's ranks then take their part of its batch by their
mesh coordinates (:func:`make_global_batch`), so the global batch is the
JAX package's row for row. Prefetch and the image pipelines come later.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from mpi_operator_tpu_torch.runtime import bootstrap
from mpi_operator_tpu_torch.runtime.topology import AXIS_DATA, AXIS_FSDP, AXIS_SEQ, mesh_sizes


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


def _batch_index(coord, sizes) -> int:
    """A rank's batch shard: its (data, fsdp) coordinate, row-major (the
    JAX package's batch spec ``("data", "fsdp")``)."""
    return coord[AXIS_DATA] * sizes[AXIS_FSDP] + coord[AXIS_FSDP]


def make_global_batch(
    host_local: Dict[str, np.ndarray], device: Union[str, torch.device], mesh=None
) -> Dict[str, torch.Tensor]:
    """This rank's part of a host batch, on its device. Integer arrays
    become int64 (the index type of PyTorch's gathers).

    Without a mesh, the whole host batch. With one, the rows split over the
    batch shards (the ``data`` × ``fsdp`` coordinates) that this host's
    ranks hold, in shard order, as ``make_array_from_process_local_data``
    lays out a process's rows; every ``tensor`` and ``sequence`` rank of a
    shard gets its rows. Over ``sequence`` (N ranks) rank s also takes only
    columns [s·T/N, (s+1)·T/N), and the batch gains that block's
    next-token ``targets`` and ``valid`` mask: the targets roll over the
    whole T, so the last column of block s predicts the first token of
    block s + 1, and only the last global position is invalid."""
    if mesh is None:
        return {name: _to_device(arr, device) for name, arr in host_local.items()}
    sizes = mesh_sizes(mesh)
    ranks = mesh.mesh.cpu().numpy()
    coords = {int(r): dict(zip(mesh.mesh_dim_names, map(int, c)))
              for c, r in np.ndenumerate(ranks)}
    first = bootstrap.process_index() * bootstrap.local_chips()
    shards = sorted({_batch_index(coords[r], sizes)
                     for r in range(first, first + bootstrap.local_chips())})
    me = coords[dist.get_rank()]
    i, n_shards = shards.index(_batch_index(me, sizes)), len(shards)
    s, n_seq = me.get(AXIS_SEQ, 0), sizes.get(AXIS_SEQ, 1)
    out = {}
    for name, arr in host_local.items():
        rows = arr.shape[0]
        if rows % n_shards:
            raise ValueError(f"a host batch of {rows} rows does not split over "
                             f"{n_shards} batch shards")
        arr = arr[i * rows // n_shards:(i + 1) * rows // n_shards]
        if n_seq > 1:
            t = arr.shape[1]
            if t % n_seq:
                raise ValueError(f"T={t} does not split over sequence={n_seq}")
            cols = slice(s * t // n_seq, (s + 1) * t // n_seq)
            if name == "tokens":
                out["targets"] = _to_device(np.roll(arr, -1, axis=1)[:, cols], device)
                valid = np.arange(t)[cols] < t - 1
                out["valid"] = _to_device(np.broadcast_to(valid, (arr.shape[0], valid.size)),
                                          device)
            arr = arr[:, cols]
        out[name] = _to_device(arr, device)
    return out


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if not t.is_floating_point() and t.dtype != torch.bool:
        t = t.long()
    return t.to(device)
