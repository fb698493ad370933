"""The PyTorch port's trainer against the JAX package's ``Trainer``.

Five steps of ``tiny()`` Llama with f32 compute on both sides, from the
same weights (``params_from_jax``) and the same ``synthetic_tokens``. The
JAX trainer runs on a one-device CPU mesh.

Tolerances: loss and grad_norm 1e-5 relative per step, parameters 1e-5
(relative and absolute) after step 5 — f32 sums taken in different orders,
which Adam's normalisation amplifies for gradients near its eps. With a
bf16 first moment the stored moment is rounded to bf16 on both sides, so a
one-ulp difference in the f32 gradient can flip a rounding: 1e-4 there.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu.ops import Trainer as JaxTrainer
from mpi_operator_tpu.ops import TrainerConfig as JaxTrainerConfig
from mpi_operator_tpu.ops.data import make_global_batch as jax_batch
from mpi_operator_tpu.ops.data import synthetic_tokens as jax_tokens
from mpi_operator_tpu.ops.trainer import _schedule
from mpi_operator_tpu.runtime import MeshPlan, build_mesh
from mpi_operator_tpu_torch.models import llama as tllama
from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
from mpi_operator_tpu_torch.ops.trainer import learning_rate

STEPS = 5


def _run_both(fields, tol):
    jc = dataclasses.replace(jllama.tiny(), compute_dtype=jax.numpy.float32)
    tc = dataclasses.replace(tllama.tiny(), compute_dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jllama.init(jc, jax.random.PRNGKey(0)))

    mesh = build_mesh(MeshPlan.data_parallel(1), jax.devices()[:1])
    jtr = JaxTrainer(
        lambda p, b: jllama.loss_fn(jc, p, b), jllama.logical_axes(jc), mesh,
        JaxTrainerConfig(**fields),
    )
    jstate = jtr.init_state(jax.tree.map(jax.numpy.asarray, tree))
    jstream = jax_tokens(global_batch=2, seq_len=32, vocab=jc.vocab)

    model = tllama.Llama(tc, device="cpu")
    model.load_state_dict(tllama.params_from_jax(tree))
    ttr = Trainer(lambda m, b: tllama.loss_fn(m, b), TrainerConfig(**fields))
    tstate = ttr.init_state(model)
    tstream = synthetic_tokens(global_batch=2, seq_len=32, vocab=tc.vocab)

    norms = []
    for step in range(STEPS):
        host = next(jstream)
        np.testing.assert_array_equal(host["tokens"], next(tstream)["tokens"])
        jstate, jm = jtr.train_step(jstate, jax_batch(mesh, host))
        tstate, tm = ttr.train_step(tstate, make_global_batch(host, "cpu"))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=tol,
                                   err_msg=f"loss at step {step}")
        assert set(tm) == set(jm)
        if "grad_norm" in jm:
            np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                       rtol=tol, err_msg=f"grad_norm at step {step}")
            norms.append(float(jm["grad_norm"]))
    assert tstate.step == int(jstate.step) == STEPS
    got = tllama.params_to_jax(tstate.params.state_dict())
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))
    return norms


def test_adamw_warmup_cosine_with_clip_matches_jax():
    norms = _run_both(dict(learning_rate=1e-2, warmup_steps=2, total_steps=STEPS,
                           weight_decay=0.1, grad_clip_norm=0.5), 1e-5)
    assert len(norms) == STEPS and min(norms) > 0.5  # the clip acts on every step


def test_adamw_bf16_first_moment_matches_jax():
    _run_both(dict(learning_rate=3e-3, adam_mu_bf16=True, grad_clip_norm=1.0), 1e-4)


@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
def test_sgd_matches_jax(optimizer):
    _run_both(dict(learning_rate=0.5, warmup_steps=3, optimizer=optimizer,
                   grad_clip_norm=0.0), 1e-5)


@pytest.mark.parametrize(
    "fields",
    [
        dict(),
        dict(warmup_steps=4),
        dict(warmup_steps=3, total_steps=10),
        dict(warmup_steps=0, total_steps=7),
        dict(warmup_steps=5, total_steps=5),
    ],
)
def test_schedule_matches_optax(fields):
    cfg = dict(learning_rate=2e-3, **fields)
    sched = _schedule(JaxTrainerConfig(**cfg))
    for count in range(14):
        np.testing.assert_allclose(
            learning_rate(TrainerConfig(**cfg), count), float(sched(count)), rtol=1e-6,
            atol=1e-12, err_msg=f"count {count}",
        )


def test_clip_matches_optax_below_and_above_the_norm():
    from mpi_operator_tpu_torch.ops.trainer import clip_by_global_norm_, global_norm

    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    norm = float(optax.global_norm(grads))
    np.testing.assert_allclose(global_norm([torch.from_numpy(g) for g in grads]).item(), norm,
                               rtol=1e-6)
    for max_norm in (norm / 2, norm * 2):
        want, _ = optax.clip_by_global_norm(max_norm).update(grads, None)
        got = [torch.from_numpy(g.copy()) for g in grads]
        np.testing.assert_allclose(clip_by_global_norm_(got, max_norm).item(), norm, rtol=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        Trainer(lambda m, b: 0.0, TrainerConfig(optimizer="lamb"))
