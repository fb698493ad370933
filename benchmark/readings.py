"""What the comparison reads from a training step, on either side, and how it
judges the program's readings against the reference's.

A side's readings are each step's loss, the norm of each leaf's first
gradient as the optimizer got it, and the norm of each leaf's change over
the first steps (for a model with running statistics, their change apart;
a family may add both after the first step alone).
The program's first gradient is worked out from its optimizer state after
step 1: AdamW's second moment is then (1 - b2) g^2, momentum's trace g.

Each number compared is a worst case: the largest relative loss gap over
the steps, and over the leaves the gap between the two sides' norms over
the reference's norm of that leaf or of the median leaf, whichever is
larger (some gradients are all but zero). A leaf whose first reference
gradient is under a thousandth of the median leaf's is left out of the
change: it moves by round-off alone under Adam.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch

Norms = Dict[str, float]


def norm(t: torch.Tensor) -> float:
    return float(t.double().pow(2).sum().sqrt())


def first_grad_norms(opt_state: Dict[str, Dict[str, torch.Tensor]], opt: dict) -> Norms:
    """Each leaf's first gradient norm from the optimizer's state after step 1."""
    if "nu" in opt_state:
        b2 = float(opt["beta2"])
        return {n: float((nu.double().sum() / (1.0 - b2)).sqrt())
                for n, nu in opt_state["nu"].items()}
    return {n: norm(t) for n, t in opt_state["trace"].items()}


def change_norms(current: Dict[str, torch.Tensor],
                 initial: Iterable[Tuple[str, torch.Tensor]]) -> Norms:
    """||current - initial|| per leaf, ``initial`` drawn again one leaf at a time."""
    return {n: norm(current[n].detach().float() - t0) for n, t0 in initial}


def _gaps(prog: Norms, ref: Norms, keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    names = list(ref if keep is None else keep)
    if not names:
        return {}
    floor = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names}


def _worst(gaps: Dict[str, float]) -> dict:
    if not gaps:
        return {"value": 0.0, "leaf": ""}
    leaf = max(gaps, key=gaps.get)
    return {"value": gaps[leaf], "leaf": leaf}


def _median(gaps: Dict[str, float]) -> dict:
    return {"value": statistics.median(gaps.values()) if gaps else 0.0, "leaf": ""}


def compare(prog: dict, ref: dict) -> Dict[str, dict]:
    """The numbers compared, each ``{"value", "leaf"}``: the losses' worst
    step (``loss``) and the first step's (``loss_first``); the worst leaf's
    gap of each kind (``grad``, ``change``, ``stats``), and the median
    leaf's (``grad_median``, ``change_median``, ``stats_median``), which
    hold steady from seed to seed where one leaf's gap does not; where the
    readings hold them, the worst leaf's change and statistics after the
    first step (``change_first``, ``stats_first``)."""
    loss = float("inf")
    if len(prog["losses"]) == len(ref["losses"]):
        loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    out = {"loss": {"value": loss, "leaf": ""}}
    if prog["losses"] and ref["losses"]:
        first = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
        out["loss_first"] = {"value": first, "leaf": ""}
    grad = _gaps(prog["grad"], ref["grad"])
    out["grad"], out["grad_median"] = _worst(grad), _median(grad)
    floor = statistics.median(ref["grad"].values())
    moving = [n for n in ref["change"] if ref["grad"].get(n, floor) >= 1e-3 * floor]
    change = _gaps(prog["change"], ref["change"], moving)
    out["change"], out["change_median"] = _worst(change), _median(change)
    if ref.get("change_first"):
        out["change_first"] = _worst(_gaps(prog["change_first"], ref["change_first"], moving))
    if ref.get("stats"):
        stats = _gaps(prog["stats"], ref["stats"])
        out["stats"], out["stats_median"] = _worst(stats), _median(stats)
    if ref.get("stats_first"):
        out["stats_first"] = _worst(_gaps(prog["stats_first"], ref["stats_first"]))
    return out


def judge(numbers: Dict[str, dict], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, each number the cell compares beside its limit). The cell's
    limits name the numbers it compares; a number it has no reading for is
    not correct."""
    missing = {"value": float("inf"), "leaf": ""}
    checks = {k: {"value": numbers.get(k, missing)["value"], "limit": lim,
                  "leaf": numbers.get(k, missing)["leaf"]} for k, lim in limits.items()}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
