"""The port's image input pipeline (ops/data.py) against the JAX package's.

- ``synthetic_imagenet`` draws the JAX package's stream bit for bit (f32
  and uint8 images, labels, a host's share of a multi-host batch);
- ``imagenet_normalize`` matches within 1e-6;
- twins of the four ``prefetch`` tests of tests/test_trainer.py: producer
  errors reach the consumer, ``close()`` releases the producer thread, the
  device transform applies to the batch, and the batches come in order
  with the layout ``make_global_batch`` gives them. Here on the CPU (no
  side stream: the card's path is exercised by chip_smoke.py's phase 15).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.ops import data as jax_data
from mpi_operator_tpu_torch.ops import data


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_synthetic_imagenet_is_the_jax_stream(dtype):
    kw = dict(global_batch=4, image_size=16, num_classes=10, seed=3, dtype=dtype)
    ours = next(data.synthetic_imagenet(**kw, process_index=0, process_count=1))
    theirs = next(jax_data.synthetic_imagenet(**kw))
    for name in ("image", "label"):
        assert ours[name].dtype == theirs[name].dtype
        np.testing.assert_array_equal(ours[name], theirs[name])
    assert ours["image"].shape == (4, 16, 16, 3)
    # host 1 of 2: seed + host, half the batch
    host1 = next(data.synthetic_imagenet(**{**kw, "global_batch": 8}, process_index=1,
                                         process_count=2))
    rng = np.random.default_rng(3 + 1)
    shape = (4, 16, 16, 3)
    want = (rng.integers(0, 256, shape, dtype=np.uint8) if dtype == "uint8"
            else rng.standard_normal(shape, np.float32))
    np.testing.assert_array_equal(host1["image"], want)


def test_uint8_images_stay_bytes_on_the_device():
    host = next(data.synthetic_imagenet(global_batch=2, image_size=8, dtype="uint8",
                                        process_index=0, process_count=1))
    batch = data.make_global_batch(host, "cpu")
    assert batch["image"].dtype == torch.uint8 and batch["label"].dtype == torch.int64


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_imagenet_normalize_matches_jax(dtype):
    host = next(data.synthetic_imagenet(global_batch=3, image_size=8, dtype="uint8",
                                        process_index=0, process_count=1))
    jdt = None if dtype is None else jnp.bfloat16
    want = jax_data.imagenet_normalize(jdt)({k: jnp.asarray(v) for k, v in host.items()})
    got = data.imagenet_normalize(dtype)(data.make_global_batch(host, "cpu"))
    assert got["image"].dtype == (dtype or torch.float32)
    np.testing.assert_allclose(got["image"].float().numpy(),
                               np.asarray(want["image"], np.float32),
                               atol=1e-6 if dtype is None else 1e-2, rtol=0 if dtype is None
                               else 1e-2)
    np.testing.assert_array_equal(got["label"].numpy(), host["label"])


def test_prefetch_propagates_producer_errors():
    def bad_iter():
        yield {"tokens": np.zeros((8, 4), np.int32)}
        raise RuntimeError("pipeline broke")

    gen = data.prefetch(bad_iter(), "cpu")
    next(gen)
    with pytest.raises(RuntimeError, match="pipeline broke"):
        next(gen)


def test_prefetch_close_releases_producer_thread():
    def endless():
        while True:
            yield {"tokens": np.zeros((8, 4), np.int32)}

    gen = data.prefetch(endless(), "cpu", depth=2)
    next(gen)  # the producer now fills the queue and blocks on it
    gen.close()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if not any(t.name == "tpujob-prefetch" and t.is_alive() for t in threading.enumerate()):
            break
        time.sleep(0.05)
    else:
        raise AssertionError("prefetch producer thread still alive after generator close()")


def test_prefetch_device_transform_applies_on_global_batch():
    def stream():
        return data.synthetic_tokens(global_batch=8, seq_len=4, vocab=100, process_index=0,
                                     process_count=1)

    def shift(batch):
        return {k: v + 1 for k, v in batch.items()}

    plain = next(data.prefetch(stream(), "cpu"))
    shifted = next(data.prefetch(stream(), "cpu", device_transform=shift))
    assert torch.equal(shifted["tokens"], plain["tokens"] + 1)
    assert shifted["tokens"].dtype == plain["tokens"].dtype == torch.int64


def test_prefetch_yields_sharded_batches():
    """In order and laid out as ``make_global_batch`` lays them out; the
    host transform runs before the transfer."""
    host = [{"tokens": np.full((8, 4), i, np.int32)} for i in range(3)]
    got = list(data.prefetch(iter(host), "cpu", depth=2,
                             transform=lambda b: {"tokens": b["tokens"] * 2}))
    assert [int(b["tokens"][0, 0]) for b in got] == [0, 2, 4]
    assert all(b["tokens"].shape == (8, 4) and b["tokens"].device.type == "cpu" for b in got)
    want = data.make_global_batch(host[1], "cpu")
    assert torch.equal(got[1]["tokens"], want["tokens"] * 2)
