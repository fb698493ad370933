"""The port's quantized matmul (kernels/quant_matmul.py) against the JAX
package's, on the CPU.

The first eleven tests twin tests/test_quant_matmul.py's on the port alone
(same shapes, same bounds; inputs from numpy). Then the parity checks,
each on the same numpy inputs through both packages:

- the forward: int8 within 1e-6 relative (the int32 accumulator is exact on
  both sides, only the f32 epilogue rounds), fp8 within 1e-5 (an f32 sum of
  the e4m3 products in another order);
- the straight-through gradients within 1e-6 in f32;
- 4 AdamW steps of ``tiny()`` at ``matmul_precision`` int8 and fp8, f32
  compute: losses and grad norms within 1e-5 relative, but fp8's 4th step
  within 2e-4. That step sits below what the reference itself can hold: a
  one-ulp change of every initial weight moves JAX's own 4th fp8 loss by
  8.9e-5 relative (int8: 4.2e-5 at the 3rd), since an f32 sum in another
  order flips an e4m3 rounding, a 1/16 step of one quantized value;
- ``tensor=2`` on two gloo ranks (tests/test_torch_sharded_step.py's
  ``run_ranks``) against JAX ``tensor=2`` on two CPU devices, f32: the row
  scales and column scales of ``w_down``, whose K is split, are reduced
  over the group, so the losses agree within the same bounds as on one
  device.
"""

import dataclasses
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.kernels.quant_matmul import quant_error, quant_matmul
from mpi_operator_tpu_torch.models import llama as tllama

# the package's __init__ exports the function under the module's name
jqm = importlib.import_module("mpi_operator_tpu.kernels.quant_matmul")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sharded_step import gang, run_ranks  # noqa: E402

PRECISIONS = ["int8", "fp8"]
STEPS, BATCH, SEQ = 4, 4, 32
FIELDS = dict(learning_rate=1e-2, warmup_steps=1, total_steps=STEPS, grad_clip_norm=0.5)
# per-step bounds on the losses and grad norms against JAX (the docstring says why)
STEP_TOL = {"int8": [1e-5] * STEPS, "fp8": [1e-5] * (STEPS - 1) + [2e-4]}


def _assert_steps_match(got, want, precision):
    for step, (g, w, tol) in enumerate(zip(got, want, STEP_TOL[precision])):
        assert abs(g - w) <= tol * abs(w), (step, g, w, tol)


def _xw(seed, m=32, k=64, n=48):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------- twins of tests/test_quant_matmul.py ----------


@pytest.mark.parametrize("precision", PRECISIONS)
def test_forward_tracks_exact_product(precision):
    x, w = _xw(0)
    err = quant_error(_t(x), _t(w), precision=precision)
    assert err < (0.02 if precision == "int8" else 0.06), err


def test_bf16_precision_is_identity():
    x, w = map(_t, _xw(1))
    assert torch.equal(quant_matmul(x, w, precision="bf16"), x @ w)


def test_rejects_unknown_precision():
    x, w = map(_t, _xw(2, m=2, k=4, n=2))
    with pytest.raises(ValueError, match="precision"):
        quant_matmul(x, w, precision="int4")


def test_leading_dims_flattened_and_restored():
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((2, 5, 16)).astype(np.float32))
    w = _t(rng.standard_normal((16, 8)).astype(np.float32))
    out = quant_matmul(x, w, precision="int8")
    assert out.shape == (2, 5, 8)
    assert torch.equal(out.reshape(10, 8), quant_matmul(x.reshape(10, 16), w, precision="int8"))


def test_scale_invariance_per_row():
    x, w = map(_t, _xw(4))
    exact = (x @ w).numpy()
    base = quant_matmul(x, w, precision="int8").numpy()
    x_hot = x.clone()
    x_hot[0] *= 1000.0
    hot = quant_matmul(x_hot, w, precision="int8").numpy()
    np.testing.assert_allclose(hot[1:], base[1:], atol=1e-6)
    want = exact[0] * 1000.0
    assert np.linalg.norm(hot[0] - want) / np.linalg.norm(want) < 0.02


@pytest.mark.parametrize("precision", PRECISIONS)
def test_backward_is_full_precision_straight_through(precision):
    x, w = _xw(5, m=8, k=16, n=8)
    c = _t(np.random.default_rng(6).standard_normal((8, 8)).astype(np.float32))

    def grads(fn):
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        (fn(xt, wt) * c).sum().backward()
        return xt.grad, wt.grad

    gx_q, gw_q = grads(lambda a, b: quant_matmul(a, b, precision=precision))
    gx_e, gw_e = grads(lambda a, b: a @ b)
    np.testing.assert_allclose(gx_q.numpy(), gx_e.numpy(), atol=1e-5)
    np.testing.assert_allclose(gw_q.numpy(), gw_e.numpy(), atol=1e-5)


def test_zero_input_quantizes_to_zero():
    out = quant_matmul(torch.zeros(4, 8), torch.ones(8, 3), precision="int8")
    assert not torch.isnan(out).any() and torch.equal(out, torch.zeros(4, 3))


def test_jit_compatible():
    """The JAX test holds jit against eager; the port has no jit, so its
    twin holds the autograd path (grad enabled) against the bare forward
    (no_grad): one function either way."""
    x, w = map(_t, _xw(6, m=4, k=8, n=4))
    with torch.no_grad():
        eager = quant_matmul(x, w, precision="int8")
    traced = quant_matmul(x.requires_grad_(), w, precision="int8")
    np.testing.assert_allclose(eager.numpy(), traced.detach().numpy(), atol=1e-6)


def _tiny(precision):
    """tiny() at ``precision`` from one seed (the draws do not depend on
    it), and a batch of tokens."""
    cfg = dataclasses.replace(tllama.tiny(), matmul_precision=precision)
    model = tllama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 16)))
    return model, tokens


@pytest.mark.parametrize("precision", PRECISIONS)
def test_llama_ffn_quant_loss_tracks_bf16(precision):
    model, tokens = _tiny("bf16")
    qmodel, _ = _tiny(precision)
    with torch.no_grad():
        base = float(tllama.loss_fn(model, {"tokens": tokens}))
        quant = float(tllama.loss_fn(qmodel, {"tokens": tokens}))
    assert abs(quant - base) / base < 0.05, (base, quant)


def test_llama_ffn_quant_trains():
    model, tokens = _tiny("int8")
    loss = tllama.loss_fn(model, {"tokens": tokens})
    loss.backward()
    # gradients reach the quantized FFN weights via the straight-through backward
    assert float(model.layers[0].w_gate.grad.abs().max()) > 0.0
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(0.5 * p.grad)
        assert float(tllama.loss_fn(model, {"tokens": tokens})) < float(loss)


def test_llama_config_rejects_bad_precision():
    with pytest.raises(ValueError, match="matmul_precision"):
        dataclasses.replace(tllama.tiny(), matmul_precision="int4")


# ---------- parity with the JAX package ----------


@pytest.mark.parametrize("precision, tol", [("int8", 1e-6), ("fp8", 1e-5)])
@pytest.mark.parametrize("shape", [(32, 64, 48), (3, 5, 16, 24)])
def test_forward_matches_jax(precision, tol, shape):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape[:-1]).astype(np.float32) * 3.0
    w = rng.standard_normal(shape[-2:]).astype(np.float32)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jnp.asarray(w), precision=precision))
    got = quant_matmul(_t(x), _t(w), precision=precision).numpy()
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())
    assert quant_error(_t(x), _t(w), precision=precision) == pytest.approx(
        jqm.quant_error(jnp.asarray(x), jnp.asarray(w), precision=precision), rel=1e-4)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_straight_through_gradients_match_jax(precision):
    x, w = _xw(8, m=12, k=24, n=16)
    c = np.random.default_rng(9).standard_normal((12, 16)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jqm.quant_matmul(a, b, precision=precision) * c),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    (quant_matmul(xt, wt, precision=precision) * _t(c)).sum().backward()
    for got, ref in zip((xt.grad, wt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _jax_steps(precision, tree, plan="data=1"):
    from mpi_operator_tpu.models import llama as jllama
    from mpi_operator_tpu.ops import Trainer, TrainerConfig
    from mpi_operator_tpu.ops.data import make_global_batch, synthetic_tokens
    from mpi_operator_tpu.runtime import MeshPlan, build_mesh

    jc = dataclasses.replace(jllama.tiny(), compute_dtype=jnp.float32,
                             matmul_precision=precision)
    p = MeshPlan.parse(plan)
    mesh = build_mesh(p, jax.devices()[:p.total_devices])
    tr = Trainer(lambda prm, b: jllama.loss_fn(jc, prm, b, mesh=mesh), jllama.logical_axes(jc),
                 mesh, TrainerConfig(**FIELDS))
    state = tr.init_state(jax.tree.map(jnp.asarray, tree))
    stream = synthetic_tokens(global_batch=BATCH, seq_len=SEQ, vocab=jc.vocab)
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = tr.train_step(state, make_global_batch(mesh, next(stream)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


def _jax_tree():
    from mpi_operator_tpu.models import llama as jllama

    return jax.tree.map(np.asarray, jllama.init(jllama.tiny(), jax.random.PRNGKey(0)))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_tiny_trains_as_jax_at_quantized_precision(precision):
    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens

    tree = _jax_tree()
    want_losses, want_norms = _jax_steps(precision, tree)
    cfg = dataclasses.replace(tllama.tiny(), compute_dtype=torch.float32,
                              matmul_precision=precision)
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(tree))
    trainer = Trainer(tllama.loss_fn, TrainerConfig(**FIELDS))
    state = trainer.init_state(model)
    stream = synthetic_tokens(global_batch=BATCH, seq_len=SEQ, vocab=cfg.vocab)
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, make_global_batch(next(stream), "cpu"))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    _assert_steps_match(losses, want_losses, precision)
    _assert_steps_match(norms, want_norms, precision)
    assert losses[-1] < losses[0]


def _rank(local_rank, args):
    import torch.distributed as dist

    from mpi_operator_tpu_torch.ops import Trainer, TrainerConfig
    from mpi_operator_tpu_torch.ops.data import make_global_batch, synthetic_tokens
    from mpi_operator_tpu_torch.runtime import bootstrap

    mesh = gang(local_rank, args["plan"])
    cfg = dataclasses.replace(tllama.tiny(), compute_dtype=torch.float32,
                              matmul_precision=args["precision"])
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in np.load(args["weights"]).items()})
    trainer = Trainer(tllama.loss_fn, TrainerConfig(**FIELDS), mesh=mesh)
    state = trainer.init_state(model)
    stream = synthetic_tokens(global_batch=BATCH, seq_len=SEQ, vocab=cfg.vocab)
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, make_global_batch(next(stream), "cpu", mesh))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    if dist.get_rank() == 0:
        print(json.dumps({"losses": losses, "norms": norms}))
    bootstrap.shutdown()


@pytest.mark.parametrize("precision", PRECISIONS)
def test_tensor_parallel_quantized_step_matches_jax(precision, tmp_path):
    tree = _jax_tree()
    weights = tmp_path / "w.npz"
    np.savez(weights, **{k: v.numpy() for k, v in tllama.params_from_jax(tree).items()})
    got = run_ranks(__file__, 2, {"plan": "tensor=2", "precision": precision,
                                  "weights": str(weights)})
    want_losses, want_norms = _jax_steps(precision, tree, "tensor=2")
    _assert_steps_match(got["losses"], want_losses, precision)
    _assert_steps_match(got["norms"], want_norms, precision)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), json.loads(sys.argv[2]))
