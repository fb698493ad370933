"""The port's AFMoE (``models/afmoe.py`` over ``parallel/moe.TokenChoiceMoE``)
against the benchmark's plain float32 reference (``benchmark/reference/
afmoe.py``, which imports nothing of the port), on the CPU at a tiny size:
2 dense and 4 MoE layers (S S S G S S), window 8 at T 32, 8 experts at top-2
and a shared one, in float32, from the weights the benchmark draws.

- logits, the loss and every leaf's gradient within 1e-4 (the two sides sum
  in other orders; no rounding to a lower precision anywhere);
- two AdamW steps with the expert bias's step after each, through
  ``Trainer.train_step`` and ``make_global_batch`` as the benchmark runs
  them, against the reference's: losses, first gradients, changes, biases;
- the layer's parts: dispatch is dropless, the counters are a bincount of
  the selections and the remat's recompute adds nothing, the bias rule
  moves load toward the mean, the grouped products equal the per-expert
  loop, and the axes the model cannot run over are refused.
"""

import dataclasses
import functools
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import readings, spec
from benchmark.families import afmoe as fam
from benchmark.reference import afmoe as ref
from mpi_operator_tpu_torch.models import MODELS, afmoe, llama
from mpi_operator_tpu_torch.ops.trainer import Trainer
from mpi_operator_tpu_torch.parallel import moe
from mpi_operator_tpu_torch.runtime import stepstats

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sharded_step import gang, run_ranks  # noqa: E402

TOL = 1e-4
SEED = 2 ** 33 + 7
TYPES = ["sliding_attention"] * 3 + ["full_attention"]
CONFIG = {
    "family": "afmoe", "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "head_dim": 16, "intermediate_size": 96, "moe_intermediate_size": 32, "vocab_size": 256,
    "num_hidden_layers": 6, "num_dense_layers": 2, "num_experts": 8, "num_experts_per_tok": 2,
    "num_shared_experts": 1, "route_scale": 2.0, "route_norm": True, "score_func": "sigmoid",
    "sliding_window": 8, "layer_types": TYPES * 2, "global_attn_every_n_layers": 4,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "load_balance_coeff": 1e-3,
    "mup_enabled": True,
    "assumed": {"initializer_range": 0.1, "compute_dtype": "float32", "remat_layers": True,
                "ce_chunk": 16, "optimizer": "adamw", "learning_rate": 1e-3, "beta1": 0.9,
                "beta2": 0.95, "weight_decay": 0.0, "adam_mu_bf16": False,
                "grad_clip_norm": 1.0},
}
MIX = {"kind": "tokens", "global_batch": 2, "seq_len": 32, "pool": 2, "ids": "zipf",
       "zipf_exponent": 1.0, "feed": "copy"}
CELL = spec.Cell("tiny-afmoe.t32", {"reference_steps": 2}, CONFIG, MIX, [], [])


def _close(got, want, tol=TOL):
    got, want = got.detach(), want.detach()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, scale)


def _program(remat=True):
    model = afmoe.AFMoE(dataclasses.replace(fam.model_config(CONFIG), remat_layers=remat))
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in fam.draw(CONFIG, SEED, "cpu"):
            params[name].copy_(t)
    return model


def _tokens():
    return torch.from_numpy(fam.pool(MIX, CONFIG, SEED, "cpu")[0]["tokens"]).long()


def test_registry_builds_the_published_and_tiny_configs():
    module, factory = MODELS["trinity-mini"]
    c = factory()
    assert module is afmoe and (c.d_model, c.n_experts, c.top_k, c.window) == (2048, 128, 8, 2048)
    assert [c.is_global(i) for i in range(8)] == [False, False, False, True] * 2
    tiny = MODELS["afmoe-tiny"][1]()
    assert afmoe.param_count(tiny) == sum(p.numel() for p in afmoe.AFMoE(tiny).parameters())


def test_logits_and_loss_match_the_reference():
    tokens = _tokens()
    model = _program()
    w = dict(fam.draw(CONFIG, SEED, "cpu"))
    s = ref.Shape(CONFIG)
    with torch.no_grad():
        _close(afmoe.apply(model, tokens), ref.logits(w, tokens, s, ref.new_biases(s, "cpu")))
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


def test_two_adamw_steps_with_the_bias_update_match_the_reference():
    """Through the benchmark's own session (``Trainer.train_step`` on batches
    from ``make_global_batch``) and its reference: every number the cell's
    ``correct`` compares, and the expert biases after both updates."""
    session = fam.Session(CELL, SEED, torch.device("cpu"))
    prog = session.first_steps(2)
    w = dict(fam.draw(CONFIG, SEED, "cpu"))
    batches = [torch.from_numpy(b["tokens"]).long() for b in fam.pool(MIX, CONFIG, SEED, "cpu")]
    biases = fam.start_biases(w, batches[0], CONFIG)
    ref.train(w, batches, CONFIG, biases=biases)
    layers = session.state.params.layers
    for i, b in biases.items():
        assert float(b.abs().max()) > 0
        _close(layers[i].moe.expert_bias, b)
    numbers = readings.compare(prog, fam.reference(CELL, SEED, torch.device("cpu"), 2))
    for key in ("loss", "grad", "change"):
        assert numbers[key]["value"] <= TOL, (key, numbers[key])


@pytest.mark.parametrize("assumed", [{"warmup_steps": 3}, {"post_norm_gain": 0.125},
                                     {"warmup_steps": 2, "post_norm_gain": 0.125}])
def test_two_steps_of_the_warmed_up_recipe_match_the_reference(assumed):
    """The cell's recipe (the learning rate warmed up from 0, the post norms'
    gains below 1) through the benchmark's session and its reference: every
    number the cell's ``correct`` compares."""
    config = dict(CONFIG, assumed=dict(CONFIG["assumed"], **assumed))
    cell = dataclasses.replace(CELL, config=config)
    prog = fam.Session(cell, SEED, torch.device("cpu")).first_steps(2)
    numbers = readings.compare(prog, fam.reference(cell, SEED, torch.device("cpu"), 2))
    for key in ("loss", "grad", "change"):
        assert numbers[key]["value"] <= TOL, (key, numbers[key])


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_the_references_warmup_is_the_trainers(warmup):
    """Update n (1 for the first) takes the trainer's rate at its count n - 1:
    0 first under a warmup, then linear up to the configured rate."""
    from mpi_operator_tpu_torch.ops.trainer import TrainerConfig, learning_rate

    opt = dict(CONFIG["assumed"], warmup_steps=warmup)
    c = TrainerConfig(learning_rate=opt["learning_rate"], warmup_steps=warmup)
    for n in range(1, 7):
        assert ref.learning_rate(opt, n) == pytest.approx(learning_rate(c, n - 1), abs=1e-15)
    assert ref.learning_rate(opt, 1) == (0.0 if warmup else opt["learning_rate"])


@pytest.mark.parametrize("gain", [1.0, 0.125])
def test_draw_gives_the_post_norms_their_gain(gain):
    config = dict(CONFIG, assumed=dict(CONFIG["assumed"], post_norm_gain=gain))
    norms = {n: t for n, t in fam.draw(config, SEED, "cpu") if t.dim() == 1}
    for name, t in norms.items():
        want = gain if name.endswith(("norm_post_attn", "norm_post_mlp")) else 1.0
        assert torch.equal(t, torch.full_like(t, want)), name


@pytest.mark.parametrize("batch", [0, 1])
def test_the_balanced_start_evens_the_first_batch(batch):
    """``balanced_biases`` solves each MoE layer's bias so that the forward of
    the batch it is given routes evenly; both sides start from it."""
    w = dict(fam.draw(CONFIG, SEED, "cpu"))
    tokens = torch.from_numpy(fam.pool(MIX, CONFIG, SEED, "cpu")[batch]["tokens"]).long()
    biases = fam.start_biases(w, tokens, CONFIG)
    s = ref.Shape(CONFIG)
    assert sorted(biases) == list(range(s.dense, s.layers))
    with torch.no_grad():
        _, _, counts = ref.loss_and_grads(w, tokens, s, biases)
    for i, c in counts.items():
        assert float(c.max() / c.mean()) <= 1.25, (i, c.tolist())
        assert abs(float(biases[i].sum())) < 1e-5 and float(biases[i].abs().max()) > 0


@pytest.mark.parametrize("spread", [0.0, 0.3])
def test_even_bias_evens_skewed_scores(spread):
    """Scores that favour a few experts for every row: the solved bias gives
    each expert its share of the N·k assignments, within a row or two."""
    g = torch.Generator().manual_seed(7)
    scores = torch.sigmoid(torch.randn(4096, 16, generator=g)
                           + spread * torch.arange(16.0) + 0.5 * torch.randn(16, generator=g))
    bias = ref.even_bias(scores, 4)
    c = torch.bincount(torch.topk(scores + bias, 4).indices.reshape(-1), minlength=16)
    assert int(c.max() - c.min()) <= 0.02 * 1024, c.tolist()


@pytest.mark.parametrize("pattern", ["random", "one_expert", "two_experts", "every_expert"])
def test_dispatch_is_dropless(pattern):
    """Every (token, slot) pair gets its own row, inside its expert's padded
    group and in token order there; the groups' ends are padded to
    ROW_ALIGN; the buffer's length is fixed by the shapes alone."""
    t, k, e = 37, 3, 8
    g = torch.Generator().manual_seed(3)
    experts = {
        "random": torch.stack([torch.randperm(e, generator=g)[:k] for _ in range(t)]),
        "one_expert": torch.stack([torch.tensor([0, 1, 2])] * t),
        "two_experts": torch.stack([torch.tensor([5, 7, i % 5]) for i in range(t)]),
        "every_expert": torch.arange(t * k).view(t, k) % e,
    }[pattern]
    dest, ends, counts, rows = moe.dispatch(experts, e)
    assert int(counts.sum()) == t * k and rows == t * k + e * (moe.ROW_ALIGN - 1)
    assert counts.tolist() == torch.bincount(experts.reshape(-1), minlength=e).tolist()
    assert len(set(dest.reshape(-1).tolist())) == t * k and int(ends[-1]) <= rows
    assert all(int(n) % moe.ROW_ALIGN == 0 for n in ends)
    starts = ends.long() - (counts + moe.ROW_ALIGN - 1) // moe.ROW_ALIGN * moe.ROW_ALIGN
    for x in range(e):
        mine = dest[experts == x]
        assert mine.tolist() == list(range(int(starts[x]), int(starts[x] + counts[x])))


def test_every_routed_row_is_computed():
    """A token's output is its k experts' weighted outputs plus the shared
    expert's, none dropped: against the per-token sum written out."""
    c = moe.TopKConfig(compute_dtype=torch.float32, route_scale=2.0)
    layer = moe.TokenChoiceMoE(c)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    x = torch.randn(2, 19, c.d_model, generator=g)
    y = layer(x, count=False).reshape(-1, c.d_model)
    xs = x.reshape(-1, c.d_model)
    experts, weights = moe.route(torch.sigmoid(xs @ layer.router), layer.expert_bias, c)
    for i in range(xs.shape[0]):
        want = layer._shared(xs[i:i + 1])[0]
        for j in range(c.top_k):
            e = int(experts[i, j])
            h = torch.nn.functional.silu(xs[i] @ layer.w_gate[e]) * (xs[i] @ layer.w_up[e])
            want = want + weights[i, j] * (h @ layer.w_down[e])
        _close(y[i], want, 1e-5)


@pytest.mark.parametrize("remat", [True, False])
def test_counters_are_a_bincount_of_the_selections(remat):
    """During a capture each MoE layer counts its rows per expert (those of
    the forward, not the remat's recompute), the busiest expert, its padding
    and its assignments (T·k); ``expert_load`` holds the same rows."""
    from torch.profiler import ProfilerActivity, profile

    model = _program(remat)
    seen = {}

    def keep_first(module, args):
        seen.setdefault(module.name, args[0].detach().clone())

    for m in model.moe_layers():
        m.register_forward_pre_hook(keep_first)
    stepstats.reset_counters()
    tokens = _tokens()
    with profile(activities=[ProfilerActivity.CPU]):
        llama.loss_fn(model, {"tokens": tokens}, ce_chunk=16).backward()
        stepstats.count_step()
    totals = stepstats.counter_totals()
    stepstats.reset_counters()
    assert totals["steps"] == 1
    c = model.config
    for m in model.moe_layers():
        xs = seen[m.name].reshape(-1, c.d_model)
        chosen, _ = moe.route(torch.sigmoid(xs.float() @ m.router), m.expert_bias, m.config)
        want = torch.bincount(chosen.reshape(-1), minlength=c.n_experts)
        got = totals["counters"]
        assert got[f"{m.name}.rows"] == want.tolist() == m.expert_load.tolist()
        assert got[f"{m.name}.assignments"] == tokens.numel() * c.top_k
        assert got[f"{m.name}.max_rows"] == float(want.max())
        padded = (want + moe.ROW_ALIGN - 1) // moe.ROW_ALIGN * moe.ROW_ALIGN
        assert got[f"{m.name}.padding"] == float((padded - want).sum())


def test_counters_count_only_during_a_capture():
    stepstats.reset_counters()
    model = _program()
    llama.loss_fn(model, {"tokens": _tokens()}, ce_chunk=16).backward()
    stepstats.count_step()
    assert stepstats.counter_totals() == {"steps": 0, "counters": {}}
    assert float(model.moe_layers()[0].expert_load.sum()) > 0  # the rule's own count


@pytest.mark.parametrize("load,moves", [
    ([4, 4, 4, 4], [0, 0, 0, 0]),
    ([10, 2, 2, 2], [-1, 1, 1, 1]),
    ([5, 3, 4, 4], [-1, 1, 0, 0]),
])
def test_the_bias_step_moves_toward_the_mean(load, moves):
    """δ = coeff·sign(mean(c) − c), bias += δ − mean(δ): a busy expert's bias
    falls below an idle one's, the biases sum to zero, the count restarts."""
    c = moe.TopKConfig(n_experts=4, top_k=1, balance_coeff=0.01)
    layer = moe.TokenChoiceMoE(c)
    layer.expert_load.copy_(torch.tensor(load, dtype=torch.float32))
    layer.after_update()
    delta = torch.tensor(moves, dtype=torch.float32) * 0.01
    _close(layer.expert_bias, delta - delta.mean(), 1e-6)
    assert abs(float(layer.expert_bias.sum())) < 1e-7
    assert float(layer.expert_load.abs().sum()) == 0


@pytest.mark.parametrize("coeff", [0.02, 0.05])
def test_the_bias_rule_evens_a_skewed_load(coeff):
    """Rows whose scores favour two experts: step after step the bias pulls
    the busiest expert's load toward the mean."""
    c = moe.TopKConfig(compute_dtype=torch.float32, balance_coeff=coeff)
    layer = moe.TokenChoiceMoE(c)
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        layer.router[:, :2] += 0.05  # experts 0 and 1 score higher for most rows
    x = torch.randn(1, 256, c.d_model, generator=g).abs()
    loads = []
    for _ in range(40):
        with torch.no_grad():
            layer(x, count=True)
        loads.append(float(layer.expert_load.max() / layer.expert_load.mean()))
        layer.after_update()
    assert loads[0] > 1.5 and loads[-1] < 0.7 * loads[0], loads


@pytest.mark.parametrize("counts", [[3, 0, 9, 5], [0, 0, 16, 0], [8, 8, 8, 8], [1, 2, 3, 4]])
def test_grouped_products_equal_the_per_expert_loop(counts):
    """``torch._grouped_mm`` (the card's path of ``moe.grouped_mm``, whose
    backward is the transposed grouped products; it runs on the CPU too)
    against one product per expert, forward and backward, on a buffer padded
    as the layer pads it: empty groups, and rows past the last group that
    neither side reads."""
    g = torch.Generator().manual_seed(1)
    padded = [(n + moe.ROW_ALIGN - 1) // moe.ROW_ALIGN * moe.ROW_ALIGN for n in counts]
    ends = torch.tensor(padded, dtype=torch.int32).cumsum(0).to(torch.int32)
    rows = int(ends[-1]) + 5
    x = torch.randn(rows, 16, generator=g).to(torch.bfloat16)
    w = torch.randn(len(counts), 16, 24, generator=g).to(torch.bfloat16)
    dy = torch.randn(rows, 24, generator=g).to(torch.bfloat16)
    dy[int(ends[-1]):] = 0  # the layer's gather sends nothing to rows past the groups
    outs = []
    for fn in (lambda a, b, e: torch._grouped_mm(a, b, offs=e), moe.grouped_mm_plain):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xg, wg, ends)
        y.backward(dy)
        outs.append((y[:int(ends[-1])].float(), xg.grad[:int(ends[-1])].float(),
                     wg.grad.float()))
    for got, want in zip(*outs):
        _close(got, want, 1e-2)  # bf16 products, summed in other orders


def test_axes_it_cannot_run_over_are_refused():
    model = afmoe.AFMoE(afmoe.tiny())

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
    with pytest.raises(ValueError, match="expert"):
        moe.check_mesh(mesh(expert=4))


def _loads_and_step(model, tokens):
    """Each MoE layer's rows per expert in the training forward of ``tokens``
    (a forward without gradients counts nothing), then the bias step."""
    model(tokens)
    loads = [m.expert_load.clone() for m in model.moe_layers()]
    model.after_update()
    return loads


def _balance_rank(local_rank, args):
    from mpi_operator_tpu_torch.runtime import bootstrap

    mesh = gang(local_rank, args["plan"])
    model = _program()
    model.set_parallel(mesh)
    batch = fam.pool(MIX, CONFIG, SEED, "cpu")[local_rank]["tokens"]  # each rank its own rows
    loads = _loads_and_step(model, torch.from_numpy(batch).long())
    np.savez(args["out"] + f".{local_rank}.npz",
             loads=torch.stack(loads).numpy(),
             biases=torch.stack([m.expert_bias for m in model.moe_layers()]).numpy())
    print(json.dumps({"rank": local_rank}))
    bootstrap.shutdown()


def test_the_bias_step_sums_every_ranks_rows(tmp_path):
    """On two data ranks with other rows each, the bias step reads the rows
    routed on both (an all-reduce of ``expert_load``), so both ranks' biases
    are equal, and equal to the step taken on the two ranks' summed rows."""
    run_ranks(__file__, 2, {"plan": "data=2", "out": str(tmp_path / "out")})
    got = [dict(np.load(tmp_path / f"out.{r}.npz")) for r in range(2)]
    assert np.array_equal(got[0]["biases"], got[1]["biases"])
    assert not np.array_equal(got[0]["loads"], got[1]["loads"])
    total = torch.from_numpy(got[0]["loads"] + got[1]["loads"])
    for i, c in enumerate(total):
        delta = CONFIG["load_balance_coeff"] * torch.sign(c.mean() - c)
        _close(torch.from_numpy(got[0]["biases"][i]), delta - delta.mean(), 1e-6)


def test_trains_through_the_trainer_from_the_registry():
    module, factory = MODELS["afmoe-tiny"]
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


if __name__ == "__main__":
    _balance_rank(int(sys.argv[1]), json.loads(sys.argv[2]))
