"""Input pipelines: synthetic token and image streams, and device prefetch.

Port of ``mpi_operator_tpu/ops/data.py``. The synthetic streams draw per
host from the same ``np.random.default_rng(seed + host)``,
``global_batch // hosts`` rows, so tokens and images are the JAX
package's, bit for bit, whatever the number of chips per host. A host's
ranks then take their part of its batch by their mesh coordinates
(:func:`make_global_batch`), so the global batch is the JAX package's row
for row.

:func:`prefetch` keeps ``depth`` batches in flight on the device from a
producer thread, as the JAX one does: on the card it copies from pinned
host memory with ``non_blocking=True`` on a side stream, runs the
``device_transform`` (:func:`imagenet_normalize`) there too, and records
an event that the consumer's stream waits on before it uses the batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from mpi_operator_tpu_torch.runtime import bootstrap
from mpi_operator_tpu_torch.runtime.stepstats import span
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


def synthetic_imagenet(
    *,
    global_batch: int,
    image_size: int = 224,
    num_classes: int = 1000,
    seed: int = 0,
    dtype: str = "float32",
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Host-local synthetic ImageNet stream: this host's share of every
    global batch, NHWC images and int32 labels, the same arrays each step
    (tf_cnn_benchmarks' synthetic data measures compute, not IO).
    ``dtype="uint8"`` yields byte images, 4x fewer bytes over PCIe, for
    :func:`imagenet_normalize` on the device."""
    if process_index is None:
        process_index = bootstrap.process_index()
    if process_count is None:
        process_count = bootstrap.process_count()
    local = global_batch // process_count
    rng = np.random.default_rng(seed + process_index)
    shape = (local, image_size, image_size, 3)
    if dtype == "uint8":
        images = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        images = rng.standard_normal(shape, np.float32)
    labels = rng.integers(0, num_classes, (local,)).astype(np.int32)
    while True:
        yield {"image": images, "label": labels}


def imagenet_normalize(compute_dtype: Optional[torch.dtype] = None) -> Callable[[Dict], Dict]:
    """The on-device input transform: uint8 NHWC images → mean/std
    normalized (ImageNet statistics in the 0–255 range), as ``compute_dtype``
    (f32 by default). Pass it as :func:`prefetch`'s ``device_transform``."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float32) * 255.0
    std = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float32) * 255.0
    dt = compute_dtype or torch.float32
    on_device = {}  # device → (mean, std) there, copied once

    def tf(batch):
        out = dict(batch)
        img = batch["image"].float()
        if img.device not in on_device:
            on_device[img.device] = (mean.to(img.device), std.to(img.device))
        m, s = on_device[img.device]
        out["image"] = ((img - m) / s).to(dt)
        return out

    return tf


def _batch_index(coord, sizes) -> int:
    """A rank's batch shard: its (data, fsdp) coordinate, row-major (the
    JAX package's batch spec ``("data", "fsdp")``)."""
    return coord[AXIS_DATA] * sizes[AXIS_FSDP] + coord[AXIS_FSDP]


def make_global_batch(
    host_local: Dict[str, np.ndarray], device: Union[str, torch.device], mesh=None,
    *, non_blocking: bool = False,
) -> Dict[str, torch.Tensor]:
    """This rank's part of a host batch, on its device. int32 arrays become
    int64 (the index type of PyTorch's gathers); uint8 images stay bytes.
    ``non_blocking``: to a CUDA device, each array is pinned and copied
    asynchronously on the current stream (:func:`prefetch`).

    Without a mesh, the whole host batch. With one, the rows split over the
    batch shards (the ``data`` × ``fsdp`` coordinates) that this host's
    ranks hold, in shard order, as ``make_array_from_process_local_data``
    lays out a process's rows; every ``tensor`` and ``sequence`` rank of a
    shard gets its rows. Over ``sequence`` (N ranks) rank s also takes only
    columns [s·T/N, (s+1)·T/N), and the batch gains that block's
    next-token ``targets`` and ``valid`` mask: the targets roll over the
    whole T, so the last column of block s predicts the first token of
    block s + 1, and only the last global position is invalid.

    During a capture on the calling thread, the call is the span
    ``data.batch`` (runtime/stepstats.py); :func:`prefetch`'s producer
    thread records none."""
    with span("data.batch"):
        return _global_batch(host_local, device, mesh, non_blocking)


def _global_batch(host_local, device, mesh, non_blocking):
    def to_device(arr):
        return _to_device(arr, device, non_blocking)

    if mesh is None:
        return {name: to_device(arr) for name, arr in host_local.items()}
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
                out["targets"] = to_device(np.roll(arr, -1, axis=1)[:, cols])
                valid = np.arange(t)[cols] < t - 1
                out["valid"] = to_device(np.broadcast_to(valid, (arr.shape[0], valid.size)))
            arr = arr[:, cols]
        out[name] = to_device(arr)
    return out


def _to_device(arr: np.ndarray, device, non_blocking: bool = False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if not t.is_floating_point() and t.dtype not in (torch.bool, torch.uint8):
        t = t.long()
    if non_blocking and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _record_stream(batch: Any, stream) -> None:
    """Mark every tensor of ``batch`` as used on ``stream``: the caching
    allocator then keeps its memory until that stream's work on it is done."""
    if isinstance(batch, torch.Tensor):
        batch.record_stream(stream)
    elif isinstance(batch, dict):
        for v in batch.values():
            _record_stream(v, stream)


def prefetch(
    it: Iterator[Dict[str, np.ndarray]],
    device: Union[str, torch.device],
    *,
    mesh=None,
    depth: int = 2,
    transform: Optional[Callable[[Dict[str, np.ndarray]], Any]] = None,
    device_transform: Optional[Callable[[Any], Any]] = None,
) -> Iterator[Any]:
    """Device prefetch: a producer thread keeps up to ``depth`` batches
    (this rank's parts, :func:`make_global_batch`) in flight on ``device``,
    in order, so the input overlaps the train step.

    ``transform`` runs on the host (numpy, before the transfer);
    ``device_transform`` runs on the device batch after it. On a CUDA
    device both the copy (from pinned memory, ``non_blocking``) and the
    device transform run on a side stream; the producer records an event
    after them, and the consumer's current stream waits on it and takes
    the batch's tensors over (``record_stream``) before it is yielded.
    During a capture on the consumer's thread, each wait for the next
    batch is the span ``data.wait`` (runtime/stepstats.py).

    An exception in the producer is re-raised in the consumer. A consumer
    that abandons the generator early (elastic restart, exception,
    ``break``) closes it, and the close reaches the producer through a stop
    flag: without it the producer would block forever on a full queue,
    holding ``depth`` batches of device memory."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        """Deliver to the consumer unless it has gone away; the timed retry
        is what the stop flag interrupts."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce(item):
        if transform is not None:
            item = transform(item)
        batch = make_global_batch(item, device, mesh, non_blocking=cuda)
        if device_transform is not None:
            batch = device_transform(batch)
        return batch

    def producer():
        try:
            side = torch.cuda.Stream(device) if cuda else None
            for item in it:
                if stop.is_set():
                    return
                if cuda:
                    with torch.cuda.device(device), torch.cuda.stream(side):
                        batch = produce(item)
                        ready = torch.cuda.Event()
                        ready.record(side)
                    item = (batch, ready)
                else:
                    item = (produce(item), None)
                if not put(item):
                    return
            put(done)
        except BaseException as e:  # the consumer re-raises it; it must never hang
            put(e)

    t = threading.Thread(target=producer, name="tpujob-prefetch", daemon=True)
    t.start()
    try:
        while True:
            with span("data.wait"):
                item = q.get()  # the producer always delivers `done` or its exception
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                _record_stream(batch, stream)
            yield batch
    finally:
        # on exhaustion and on early abandonment: release the producer, flag
        # first, then drain the queue so a put blocked on a full queue frees
        # its slot now
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
