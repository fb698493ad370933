"""The port's ResNet (models/resnet.py) against the JAX package's, on the CPU.

resnet26 at width 8, image 64, batch 8, 10 classes, from the JAX init
trees (``params_from_jax``) and the same numpy images. Image 64 keeps the
last stage at 2×2: batch-norm statistics over n = 2 samples are badly
conditioned. The JAX stem is its space-to-depth 4×4 convolution; the
port's is the plain 7×7/s2 one, the same function.

Bounds (f32 compute): logits 1e-4 relative to their max, and the running
statistics after one training forward 1e-5; the eval forward as tight.
Three momentum-SGD steps (the bench's optimizer, no clip, at lr 1e-4, on
the synthetic stream's batch): the first loss 1e-5, the others 1e-3, the
statistics after them 1e-3. In bf16 compute the logits within 3e-2 of
their max (each side rounds its own convolutions).

The steps' bounds past the first loss are the reference's own f32
accuracy, not the 1e-5 of the Llama tests: the backward of the one-pass
batch norm is ill-conditioned at this size, and the JAX package's f32
arithmetic is far from exact there. Against a float64 run of the same
formula, on one batch JAX's f32 gradient is 2.8e-2 off (relative norm,
worst parameter) and the port's 3.2e-5; on another 1.1e-4 and 2.0e-5. A
one-ulp change of every initial weight moves JAX's own third loss by
9.3e-4 at lr 0.1; at lr 1e-2 the port and JAX part by 3.6e-3 by the third
loss. At lr 1e-4 the measured gaps are 2.2e-4 (third loss) and 2.7e-4
(statistics).

The two-rank runs of global batch norm are tests/test_torch_resnet_global_bn.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import resnet as jresnet
from mpi_operator_tpu_torch.models import resnet as tresnet


BATCH, STEPS = 8, 3
CFG = dict(depth="resnet26", width=8, image_size=64, num_classes=10)
FIELDS = dict(learning_rate=1e-4, optimizer="momentum", grad_clip_norm=0.0)
TOL_STEPS = 1e-3  # the bound against JAX past the first loss (the docstring says why)


def _configs(dtype="float32"):
    return (jresnet.Config(**CFG, compute_dtype=getattr(jnp, dtype)),
            tresnet.Config(**CFG, compute_dtype=getattr(torch, dtype)))


@functools.lru_cache(maxsize=1)
def _jax_init():
    params, state = jresnet.init(_configs()[0], jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


# the JAX forward, compiled once per (config, train) instead of op by op
_japply = jax.jit(jresnet.apply, static_argnums=(0, 4))


def _batch(seed=1, n=BATCH):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, 64, 64, 3)).astype(np.float32),
            "label": rng.integers(0, 10, (n,)).astype(np.int32)}


def _stream_batch():
    """The synthetic ImageNet stream's batch, which the trainer steps take
    every step (as the bench and the worker do)."""
    from mpi_operator_tpu_torch.ops.data import synthetic_imagenet

    return next(synthetic_imagenet(global_batch=BATCH, image_size=64, num_classes=10,
                                   process_index=0, process_count=1))


def _model(tc, params, state):
    model = tresnet.ResNet(tc, device="cpu")
    model.load_state_dict(tresnet.params_from_jax(params, state))
    return model


def _stats(model):
    return {n: b.detach().numpy().copy() for n, b in model.named_buffers()}


def _jax_stats(state):
    """The JAX BN state under the port's buffer names."""
    return {n: v for n, v in tresnet.params_from_jax(_jax_init()[0], state).items()
            if n.endswith((".mean", ".var"))}


def _close(got, want, tol):
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name], w, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_train_forward_and_running_stats_match_jax(dtype, tol):
    jc, tc = _configs(dtype)
    params, state = _jax_init()
    batch = _batch()
    # bf16: op by op, each op rounding to bf16 as the port's does (under jit
    # XLA keeps fused intermediates in f32, 0.33 of max 3.4 away from both)
    fwd = _japply if dtype == "float32" else jresnet.apply
    logits, new_state = fwd(jc, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                            jnp.asarray(batch["image"]), True)
    model = _model(tc, params, state)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["image"])).numpy()
    want = np.asarray(logits)
    assert got.dtype == np.float32 and got.shape == want.shape == (BATCH, 10)
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)
    if dtype == "float32":
        _close(_stats(model), _jax_stats(jax.tree.map(np.asarray, new_state)), 1e-5)


def test_eval_mode_uses_and_keeps_the_running_stats():
    jc, tc = _configs()
    params, state = _jax_init()
    batch = _batch()
    # moved statistics: one train forward on each side first
    _, moved = _japply(jc, params, state, batch["image"], True)
    model = _model(tc, params, state)
    with torch.no_grad():
        model(torch.from_numpy(batch["image"]))
        before = _stats(model)
        model.eval()
        got = model(torch.from_numpy(_batch(seed=2)["image"])).numpy()
    want, kept = _japply(jc, params, moved, _batch(seed=2)["image"], False)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4 * np.abs(want).max(), rtol=0)
    after = _stats(model)
    assert all(np.array_equal(after[n], before[n]) for n in before)
    assert jax.tree.all(jax.tree.map(lambda a, b: bool(jnp.all(a == b)), kept, moved))


def _jax_steps(params, state, plan="data=1"):
    from mpi_operator_tpu.ops import Trainer, TrainerConfig
    from mpi_operator_tpu.ops.data import make_global_batch
    from mpi_operator_tpu.runtime import MeshPlan, build_mesh

    jc = _configs()[0]
    p = MeshPlan.parse(plan)
    mesh = build_mesh(p, jax.devices()[:p.total_devices])
    paxes, saxes = jresnet.logical_axes(jc)
    tr = Trainer(lambda prm, s, b: jresnet.loss_fn(jc, prm, s, b), paxes, mesh,
                 TrainerConfig(**FIELDS), has_model_state=True, model_state_axes=saxes)
    st = tr.init_state(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state))
    losses = []
    for step in range(STEPS):
        st, m = tr.train_step(st, make_global_batch(mesh, _stream_batch()))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, st.model_state), jax.tree.map(np.asarray, st.params)


def _port_steps(params, state):
    """The port's one-device steps: (losses, running statistics, state dict)."""
    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.data import make_global_batch

    trainer = Trainer(tresnet.loss_fn, TrainerConfig(**FIELDS))
    st = trainer.init_state(_model(_configs()[1], params, state))
    losses = []
    for _ in range(STEPS):
        st, m = trainer.train_step(st, make_global_batch(_stream_batch(), "cpu"))
        losses.append(m["loss"].item())
    assert set(st.model_state) == {n for n in st.params.state_dict()
                                   if n.endswith((".mean", ".var"))}
    return losses, {n: b.numpy() for n, b in st.model_state.items()}, st.params.state_dict()


def test_momentum_steps_match_jax():
    params, state = _jax_init()
    want_losses, want_state, _ = _jax_steps(params, state)
    losses, stats, _ = _port_steps(params, state)
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, want_losses, rtol=TOL_STEPS)
    assert losses[-1] < losses[0]
    _close(stats, _jax_stats(want_state), TOL_STEPS)


def test_checkpoint_saves_and_restores_the_running_stats(tmp_path):
    """``TrainState.model_state`` is the buffers, and the checkpoint's state
    dict holds them: a restore brings back the statistics of the saved step."""
    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.checkpoint import CheckpointManager
    from mpi_operator_tpu_torch.ops.data import make_global_batch

    params, state = _jax_init()
    trainer = Trainer(tresnet.loss_fn, TrainerConfig(**FIELDS))
    st = trainer.init_state(_model(_configs()[1], params, state))
    st, _ = trainer.train_step(st, make_global_batch(_stream_batch(), "cpu"))
    saved = {n: b.clone() for n, b in st.model_state.items()}
    manager = CheckpointManager(str(tmp_path), save_interval_steps=1)
    manager.save(st.step, st)
    manager.wait()
    st, _ = trainer.train_step(st, make_global_batch(_stream_batch(), "cpu"))
    assert not torch.equal(st.model_state["stem_bn.mean"], saved["stem_bn.mean"])
    st = manager.restore(st)
    manager.close()
    assert st.step == 1
    assert all(torch.equal(st.model_state[n], saved[n]) for n in saved)


def test_flops_per_sample_and_axes_are_the_jax_models():
    for depth in tresnet.STAGE_BLOCKS:
        for size in (64, 224):
            kw = dict(depth=depth, image_size=size)
            assert tresnet.flops_per_sample(tresnet.Config(**kw)) == \
                jresnet.flops_per_sample(jresnet.Config(**kw))
    jc, tc = _configs()
    paxes, _ = jresnet.logical_axes(jc)
    params, state = _jax_init()
    ours = tresnet.logical_axes(tc)
    model = _model(tc, params, state)
    assert set(ours) == {n for n, _ in model.named_parameters()}
    flat = dict(jax.tree_util.tree_leaves_with_path(paxes, is_leaf=lambda x: isinstance(x, tuple)))
    conv_hwio = ("conv_kernel", "conv_kernel", "conv_in", "conv_out")
    assert sum(a == conv_hwio for a in flat.values()) == sum(
        a == ("conv_out", "conv_in", "conv_kernel", "conv_kernel") for a in ours.values())
    assert ours["head_w"] == tuple(paxes["head"]["w"]) and ours["head_b"] == tuple(paxes["head"]["b"])


def test_registry_names_the_jax_packages_models():
    from mpi_operator_tpu.models import MODELS as JAX_MODELS
    from mpi_operator_tpu_torch.models import MODELS, PORT_ONLY

    assert set(MODELS) - set(PORT_ONLY) == set(JAX_MODELS)
    assert not set(PORT_ONLY) & set(JAX_MODELS)
    for name, (module, factory) in MODELS.items():
        if name in PORT_ONLY:
            continue
        jmodule, jfactory = JAX_MODELS[name]
        assert module.__name__.rsplit(".", 1)[1] == jmodule.__name__.rsplit(".", 1)[1]
        ours, theirs = factory(), jfactory()
        fields = [f.name for f in dataclasses.fields(theirs) if f.name != "compute_dtype"]
        assert {f: getattr(ours, f) for f in fields} == {f: getattr(theirs, f) for f in fields}
