"""The port's DeepSeek-V3 blocks (``models/deepseek_v3.py``: multi-head latent
attention over ``parallel/moe.TokenChoiceMoE``) against the benchmark's
plain float32 reference (``benchmark/reference/deepseek_v3.py``, which
imports nothing of the port), on the CPU at the tiny preset's size: 1 dense
and 4 MoE layers, 4 heads of q/k 16 + 8 and v 16 over a latent of 32, 8
experts at top-2 and 2 shared, T 32, in float32, from the weights the
benchmark draws.

- logits, the loss and every leaf's gradient within 1e-4 of the largest
  value (the two sides sum in other orders and build RoPE two ways, HF's
  de-interleave then half-split against the port's rotation of adjacent
  pairs; no rounding to a lower precision anywhere);
- two AdamW steps with the expert bias's step after each, through
  ``Trainer.train_step`` as the benchmark runs them, against the
  reference's: losses, first gradients, changes, biases, within 1e-4;
- four mutations of the model each part from the reference by more than a
  hundred times that tolerance: half-split RoPE, no latent norm, the
  softmax scale of v's width, and a k_pe of its own for each head;
- the spans and the marks during a capture, the axes it refuses, and
  training from the registry.
"""

import dataclasses
import functools
import types

import pytest
import torch

from benchmark import readings, spec
from benchmark.families import deepseek_v3 as fam
from benchmark.reference import deepseek_v3 as ref
from mpi_operator_tpu_torch.models import MODELS, deepseek_v3, llama
from mpi_operator_tpu_torch.ops.trainer import Trainer
from mpi_operator_tpu_torch.runtime import stepstats

TOL = 1e-4
SEED = 2 ** 33 + 11
CONFIG = {
    "family": "deepseek_v3", "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 4, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "kv_lora_rank": 32, "q_lora_rank": None, "intermediate_size": 96,
    "moe_intermediate_size": 32, "vocab_size": 256, "num_hidden_layers": 5,
    "first_k_dense_replace": 1, "moe_layer_freq": 1, "n_routed_experts": 8,
    "num_experts_per_tok": 2, "n_shared_experts": 2, "routed_scaling_factor": 2.448,
    "norm_topk_prob": True, "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
    "topk_group": 1, "rope_interleave": True, "rope_scaling": None, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6,
    "assumed": {"initializer_range": 0.1, "compute_dtype": "float32", "remat_layers": True,
                "ce_chunk": 16, "optimizer": "adamw", "learning_rate": 1e-3, "beta1": 0.9,
                "beta2": 0.95, "weight_decay": 0.0, "adam_mu_bf16": False,
                "grad_clip_norm": 1.0, "balance_coeff": 1e-3},
}
MIX = {"kind": "tokens", "global_batch": 2, "seq_len": 32, "pool": 2, "ids": "zipf",
       "zipf_exponent": 1.0, "feed": "copy"}
CELL = spec.Cell("tiny-dsv3.t32", {"reference_steps": 2}, CONFIG, MIX, [], [])


def _err(got, want):
    """max |got - want| over max |want|."""
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _close(got, want, tol=TOL):
    err = _err(got, want)
    assert err <= tol, err


def _program(remat=True):
    model = deepseek_v3.DeepseekV3(
        dataclasses.replace(fam.model_config(CONFIG), remat_layers=remat))
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in fam.draw(CONFIG, SEED, "cpu"):
            params[name].copy_(t)
    return model


def _tokens():
    return torch.from_numpy(fam.pool(MIX, CONFIG, SEED, "cpu")[0]["tokens"]).long()


def _reference_logits(tokens):
    w = dict(fam.draw(CONFIG, SEED, "cpu"))
    s = ref.Shape(CONFIG)
    return ref.logits(w, tokens, s, ref.new_biases(s, "cpu"))


def test_registry_builds_the_published_and_tiny_configs():
    module, factory = MODELS["kanana-2-30b-a3b"]
    c = factory()
    assert module is deepseek_v3
    assert (c.d_model, c.n_layers, c.n_heads, c.qk_dim, c.v_dim, c.kv_rank) == (
        2048, 48, 32, 192, 128, 512)
    assert (c.n_experts, c.top_k, c.d_expert, c.n_shared_experts, c.n_dense_layers) == (
        128, 6, 768, 2, 1)
    tiny = MODELS["deepseek-v3-tiny"][1]()
    model = deepseek_v3.DeepseekV3(tiny)
    assert deepseek_v3.param_count(tiny) == sum(p.numel() for p in model.parameters())
    assert fam.model_config(CONFIG) == dataclasses.replace(tiny, rope_theta=10000.0,
                                                           remat_layers=True)
    # the cell's cut: 6 layers, an eighth of the vocabulary
    cut = dataclasses.replace(c, n_layers=6, vocab=16_032)
    assert deepseek_v3.param_count(cut) == 3_329_913_856


def test_logits_and_loss_match_the_reference():
    tokens = _tokens()
    model = _program()
    w = dict(fam.draw(CONFIG, SEED, "cpu"))
    s = ref.Shape(CONFIG)
    with torch.no_grad():
        _close(deepseek_v3.apply(model, tokens), _reference_logits(tokens))
        loss = llama.loss_fn(model, {"tokens": tokens}, ce_chunk=16)
    want, _, _ = ref.loss_and_grads(w, tokens, s, ref.new_biases(s, "cpu"))
    assert abs(float(loss) - want) <= TOL * abs(want)


@pytest.mark.parametrize("remat", [True, False])
def test_every_gradient_matches_the_reference(remat):
    tokens = _tokens()
    model = _program(remat)
    llama.loss_fn(model, {"tokens": tokens}, ce_chunk=16).backward()
    w = dict(fam.draw(CONFIG, SEED, "cpu"))
    s = ref.Shape(CONFIG)
    _, grads, _ = ref.loss_and_grads(w, tokens, s, ref.new_biases(s, "cpu"))
    got = dict(model.named_parameters())
    assert set(grads) == set(got)
    for name, g in grads.items():
        assert float(got[name].grad.abs().max()) > 0, name
        _close(got[name].grad, g)


@pytest.mark.parametrize("assumed", [{}, {"warmup_steps": 2, "embed_init_std": 1.0}],
                         ids=["plain", "cell_recipe"])
def test_two_adamw_steps_with_the_bias_update_match_the_reference(assumed):
    """Through the benchmark's own session (``Trainer.train_step`` on batches
    from ``make_global_batch``) and its reference: every number the cell's
    ``correct`` compares, and the expert biases after both updates; also
    under the cell's recipe (the learning rate warmed up from 0, the
    embedding drawn at std 1)."""
    config = dict(CONFIG, assumed=dict(CONFIG["assumed"], **assumed))
    cell = dataclasses.replace(CELL, config=config)
    session = fam.Session(cell, SEED, torch.device("cpu"))
    prog = session.first_steps(2)
    w = dict(fam.draw(config, SEED, "cpu"))
    batches = [torch.from_numpy(b["tokens"]).long() for b in fam.pool(MIX, config, SEED, "cpu")]
    biases = fam.start_biases(w, batches[0], config)
    ref.train(w, batches, config, biases=biases)
    layers = session.state.params.layers
    assert sorted(biases) == [1, 2, 3, 4]
    for i, b in biases.items():
        assert float(b.abs().max()) > 0
        _close(layers[i].moe.expert_bias, b)
    numbers = readings.compare(prog, fam.reference(cell, SEED, torch.device("cpu"), 2))
    for key in ("loss", "grad", "change"):
        assert numbers[key]["value"] <= TOL, (key, numbers[key])


@pytest.mark.parametrize("std", [None, 1.0])
def test_draw_gives_the_embedding_its_own_std(std):
    """``assumed``'s ``embed_init_std`` sets the embedding's draw alone (the
    cell's 1.0); without it the embedding is drawn as every matrix."""
    extra = {} if std is None else {"embed_init_std": std}
    config = dict(CONFIG, assumed=dict(CONFIG["assumed"], **extra))
    w = dict(fam.draw(config, SEED, "cpu"))
    want = std or CONFIG["assumed"]["initializer_range"]
    assert abs(float(w["embed"].std()) - want) < 0.05 * want
    assert abs(float(w["lm_head"].std()) - CONFIG["assumed"]["initializer_range"]) < 5e-3


def _half_split(monkeypatch):
    monkeypatch.setattr(deepseek_v3, "rope_interleaved", llama._rope_bhtd)


def _no_latent_norm(monkeypatch):
    real = deepseek_v3._rmsnorm
    rank = CONFIG["kv_lora_rank"]
    monkeypatch.setattr(deepseek_v3, "_rmsnorm",
                        lambda x, scale, eps: x if x.shape[-1] == rank else real(x, scale, eps))


def _scale_of_v(monkeypatch):
    real = deepseek_v3.flash_attention

    def attention(q, k, v, **kw):
        return real(q, k, v, **dict(kw, scale=v.shape[-1] ** -0.5))

    monkeypatch.setattr(deepseek_v3, "flash_attention", attention)


def _k_pe_per_head(monkeypatch):
    """Each head's k rope columns its own: the shared k_pe turned by the
    head's index over its columns, as a layout of one k_pe a head would
    read it."""
    real = deepseek_v3.flash_attention
    nope = CONFIG["qk_nope_head_dim"]

    def attention(q, k, v, **kw):
        pe = torch.stack([k[:, i, :, nope:].roll(i, dims=-1) for i in range(k.shape[1])], 1)
        return real(q, torch.cat([k[..., :nope], pe], dim=-1), v, **kw)

    monkeypatch.setattr(deepseek_v3, "flash_attention", attention)


@pytest.mark.parametrize("mutate", [_half_split, _no_latent_norm, _scale_of_v, _k_pe_per_head],
                         ids=["half_split_rope", "no_latent_norm", "v_width_scale",
                              "k_pe_per_head"])
def test_each_mutation_parts_from_the_reference(monkeypatch, mutate):
    """The comparison above sees each: the logits part by over 100 x its
    tolerance."""
    tokens = _tokens()
    want = _reference_logits(tokens)
    with torch.no_grad():
        _close(deepseek_v3.apply(_program(), tokens), want)
        mutate(monkeypatch)
        assert _err(deepseek_v3.apply(_program(), tokens), want) > 100 * TOL


def test_adjacent_pair_rope_gives_hf_scores():
    """The port's rotation of adjacent pairs and the reference's (HF's:
    the pairs gathered into halves, then the halves rotated) give the same
    q·k at every pair of positions, though not the same vectors."""
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 3, 40, 8, generator=g), torch.randn(2, 1, 40, 8, generator=g)
    port = deepseek_v3.rope_interleaved(q, 1e4) @ deepseek_v3.rope_interleaved(k, 1e4).mT
    hf = ref.rope(q, 1e4, True) @ ref.rope(k, 1e4, True).mT
    _close(port, hf, 1e-5)
    assert _err(deepseek_v3.rope_interleaved(q, 1e4), ref.rope(q, 1e4, True)) > 0.1


def test_a_captured_step_opens_the_mla_spans_and_marks(monkeypatch):
    """During a capture each layer's forward opens ``mla.q``, ``mla.kv_down``,
    ``mla.kv_up``, ``mla.rope`` and ``mla.attention`` once and the remat's
    recompute the first four again; on a CUDA device it would launch the
    ``mla_in`` and ``mla_attn`` marks (a CPU tensor launches none), and the
    MoE layers count their routing once."""
    from torch.profiler import ProfilerActivity, profile

    launched = []
    monkeypatch.setattr(deepseek_v3, "device_mark",
                        lambda device, point: launched.append((device, point)))
    model = _program()
    stepstats.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        llama.loss_fn(model, {"tokens": _tokens()}, ce_chunk=16).backward()
    names = [e.name for e in prof.events()]
    n = CONFIG["num_hidden_layers"]
    for span in ("mla.q", "mla.kv_down", "mla.kv_up", "mla.rope"):
        assert names.count(span) == 2 * n, span
    assert names.count("mla.attention") == n
    assert launched == [(None, "mla_in"), (None, "mla_attn")] * (2 * n)
    counters = stepstats.counter_totals()["counters"]
    stepstats.reset_counters()
    assert counters["layers.1.moe.assignments"] == 2 * 32 * 2


def test_axes_it_cannot_run_over_are_refused():
    model = deepseek_v3.DeepseekV3(deepseek_v3.tiny())

    def mesh(**sizes):
        return types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                     mesh=torch.empty(*sizes.values()))

    for axis in ("expert", "sequence", "tensor"):
        with pytest.raises(ValueError, match=axis):
            model.set_parallel(mesh(data=1, **{axis: 2}))
    model.set_parallel(mesh(data=1, fsdp=1))
    assert not any(m.sum_loads for m in model.moe_layers())
    model.set_parallel(mesh(data=2, fsdp=2))
    assert all(m.sum_loads for m in model.moe_layers())


def test_trains_through_the_trainer_from_the_registry():
    module, factory = MODELS["deepseek-v3-tiny"]
    model = module.init(factory(), torch.Generator().manual_seed(0), "cpu")
    trainer = Trainer(functools.partial(llama.loss_fn, ce_chunk=16))
    state = trainer.init_state(model)
    tokens = {"tokens": _tokens()}
    losses = []
    for _ in range(3):
        state, metrics = trainer.train_step(state, tokens)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert any(float(m.expert_bias.abs().sum()) > 0 for m in model.moe_layers())
