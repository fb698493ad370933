"""Tiny cells for the CPU tests: a copy of the benchmark's files in a
temporary root, with configurations, mixes and cells small enough for the
CPU, added as a later change would add them (new files and new entries)."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

DECODER = {
    "family": "decoder", "source": "test", "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
    "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
    "initializer_range": 0.02,
    "assumed": {"head_dim": 16, "compute_dtype": "bfloat16", "remat_layers": True,
                "ce_chunk": 16, "optimizer": "adamw", "learning_rate": 3e-4, "beta1": 0.9,
                "beta2": 0.95, "weight_decay": 0.0, "adam_mu_bf16": True,
                "grad_clip_norm": 1.0},
}
RESNET = {
    "family": "resnet", "source": "test", "depth": "resnet26", "stage_blocks": [2, 2, 2, 2],
    "width": 8, "image_size": 64, "channels": 3, "num_classes": 10,
    "assumed": {"bn_momentum": 0.9, "bn_epsilon": 1e-5, "compute_dtype": "float32",
                "optimizer": "momentum", "learning_rate": 0.01, "momentum": 0.9,
                "grad_clip_norm": 0.0},
}
TOKENS = {"kind": "tokens", "global_batch": 2, "seq_len": 48, "pool": 4, "feed": "copy"}
GANG_TOKENS = {**TOKENS, "global_batch": 8}
IMAGES = {"kind": "images", "global_batch": 16, "pool": 4, "image_dtype": "uint8",
          "feed": "prefetch", "prefetch_depth": 2}
# generous: the CPU tests check the plumbing and the faults, which read far above
LIMITS = {"loss": 0.05, "grad": 0.2, "change": 0.2}
# cell: (config, its file, mix, its file, reference steps, profiled steps, limits,
# chips, mesh)
CELLS = {
    "tiny-decoder.t48": ("tiny-decoder", DECODER, "t48", TOKENS, 2, 2, LIMITS, 1, ""),
    "tiny-resnet.b16": ("tiny-resnet", RESNET, "b16", IMAGES, 2, 3, {**LIMITS, "stats": 0.2},
                        1, ""),
    "tiny-decoder.fsdp4-t48": ("tiny-decoder", DECODER, "t48x4", GANG_TOKENS, 2, 2, LIMITS, 4,
                               "fsdp=4"),
}
GANG = "tiny-decoder.fsdp4-t48"


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def make_root(tmp: str) -> str:
    """A checkout-like root under ``tmp``: ``BENCHMARK.json`` and a copy of
    ``benchmark/``, with the tiny configurations, mixes and cells added and
    named in every metric whose family they share."""
    root = os.path.join(tmp, "root")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    here = os.path.join(root, "benchmark")
    for cell, (cfg_name, cfg, tr_name, tr, steps, profile, limits, chips,
               mesh) in CELLS.items():
        _dump(os.path.join(here, "configs", f"{cfg_name}.json"), cfg)
        _dump(os.path.join(here, "traffic", f"{tr_name}.json"), tr)
        _dump(os.path.join(here, "workloads", f"{cell}.json"),
              {"config": cfg_name, "traffic": tr_name, "chips": chips, "mesh": mesh,
               "reference_steps": steps, "profile_steps": profile, "limits": limits,
               "why": "a CPU test"})
        if cfg_name not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append({"name": cfg_name, "source": "test",
                                     "file": f"benchmark/configs/{cfg_name}.json",
                                     "reduced": [], "why": "a CPU test"})
        bench["workloads"].append({"name": cell, "config": cfg_name, "traffic": tr_name,
                                   "chips": chips, "why": "a CPU test"})
        unit = "tokens" if tr["kind"] == "tokens" else "images"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(_unit(w) == unit and _chips(w, bench) == chips
                                        for w in m["workloads"]):
                m["workloads"].append(cell)
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def _chips(cell: str, bench) -> int:
    return {w["name"]: w["chips"] for w in bench["workloads"]}[cell]


def _unit(cell: str) -> str:
    return "images" if cell.startswith(("resnet", "tiny-resnet")) else "tokens"
