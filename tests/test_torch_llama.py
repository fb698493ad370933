"""The PyTorch port's Llama against the JAX package's, on the same weights.

The JAX ``init`` tree is converted with ``params_from_jax``; tokens come from
numpy. ``attention_impl="auto"`` runs the flash path on both sides (the
JAX package's chunked XLA lowering off-TPU, the port's plain kernel
versions on the CPU); "dense" runs the quadratic oracle on both.

Tolerances: f32 compute, logits 1e-4 and gradients 1e-4·max|ref| per leaf
(the two frameworks sum in different orders); bf16 compute, logits 3e-2·
max|ref| and gradients 3e-2·max|ref| per leaf (rounding points of bf16
elementwise ops differ between XLA and PyTorch), loss 1e-4 relative in f32
and 1e-2 in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu_torch.models import llama as tllama

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jax_params(seed=0):
    cfg = jllama.tiny()
    return jax.tree.map(np.asarray, jllama.init(cfg, jax.random.PRNGKey(seed)))


def _configs(dtype, attention_impl):
    jdt, tdt = DTYPES[dtype]
    jc = dataclasses.replace(jllama.tiny(), compute_dtype=jdt, attention_impl=attention_impl)
    tc = dataclasses.replace(tllama.tiny(), compute_dtype=tdt, attention_impl=attention_impl)
    return jc, tc


def _model(tc, tree):
    model = tllama.Llama(tc, device="cpu")
    model.load_state_dict(tllama.params_from_jax(tree))
    return model


def _tokens(b, t, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def _assert_tree_close(got, want, rel):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        w = np.asarray(flat_want[path], np.float32)
        assert g.shape == w.shape, path
        bound = rel * max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.astype(np.float32) - w).max())
        assert err <= bound, f"{jax.tree_util.keystr(path)}: {err} > {bound}"


def test_params_round_trip_is_exact():
    tree = _jax_params()
    back = tllama.params_to_jax(tllama.params_from_jax(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_param_count_and_flops_match_jax():
    for name in ("tiny", "bench_single_chip", "bench_long_context", "llama3_8b"):
        jc, tc = getattr(jllama, name)(), getattr(tllama, name)()
        assert tllama.param_count(tc) == jllama.param_count(jc)
        assert tllama.flops_per_token(tc, 2048) == jllama.flops_per_token(jc, 2048)
        fields = [f.name for f in dataclasses.fields(jc) if f.name != "compute_dtype"]
        assert {f: getattr(tc, f) for f in fields} == {f: getattr(jc, f) for f in fields}
    tree = _jax_params()
    model = _model(tllama.tiny(), tree)
    assert sum(p.numel() for p in model.parameters()) == jllama.param_count(jllama.tiny())


def test_init_matches_jax_shapes_and_scales():
    cfg = tllama.tiny()
    model = tllama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tree = tllama.params_to_jax(model.state_dict())
    want = _jax_params()
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, want)
    # fan-in scaled normals: the std of each weight matches the JAX init's
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        got = dict(jax.tree_util.tree_leaves_with_path(tree))[path]
        np.testing.assert_allclose(got.std(), w.std(), rtol=0.2, atol=1e-6)


def test_quantized_ffn_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="quant_matmul"):
        tllama.Config(matmul_precision="int8")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attention_impl", ["auto", "dense"])
def test_logits_match_jax(dtype, attention_impl):
    jc, tc = _configs(dtype, attention_impl)
    tree = _jax_params()
    tokens = _tokens(2, 24, jc.vocab)
    want = np.asarray(jllama.apply(jc, jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens)))
    with torch.no_grad():
        got = tllama.apply(_model(tc, tree), torch.from_numpy(tokens).long()).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


@pytest.mark.parametrize(
    "dtype,attention_impl,t,ce_chunk",
    [
        ("f32", "auto", 24, 2048),  # T ≤ ce_chunk: whole-sequence CE
        ("f32", "auto", 40, 16),  # chunked CE, roll-shift and a ragged last chunk
        ("f32", "dense", 40, 16),
        ("bf16", "auto", 24, 2048),
        ("bf16", "auto", 40, 16),
    ],
)
def test_loss_and_grads_match_jax(dtype, attention_impl, t, ce_chunk):
    jc, tc = _configs(dtype, attention_impl)
    tree = _jax_params()
    tokens = _tokens(2, t, jc.vocab)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jc, p, {"tokens": jnp.asarray(tokens)}, ce_chunk=ce_chunk)
    )(jax.tree.map(jnp.asarray, tree))
    model = _model(tc, tree)
    loss = tllama.loss_fn(model, {"tokens": torch.from_numpy(tokens).long()}, ce_chunk=ce_chunk)
    loss.backward()
    grads = tllama.params_to_jax({n: p.grad for n, p in model.named_parameters()})
    rel = 1e-4 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=rel)
    _assert_tree_close(grads, jax.tree.map(np.asarray, jgrads), 1e-4 if dtype == "f32" else 3e-2)


def test_remat_layers_gives_the_same_grads():
    _, tc = _configs("f32", "auto")
    tree = _jax_params()
    tokens = {"tokens": torch.from_numpy(_tokens(2, 24, tc.vocab)).long()}
    grads = []
    for remat in (False, True):
        model = _model(dataclasses.replace(tc, remat_layers=remat), tree)
        tllama.loss_fn(model, tokens).backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
