"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of the
checkout, and under this folder one JSON file per configuration
(``configs/<name>.json``), per traffic mix (``traffic/<name>.json``) and per
cell (``workloads/<name>.json``), and one reader per metric
(``metrics/<name>.py``). A new cell, configuration, mix or metric is a new
file and a new entry in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def check_name(name: str) -> str:
    """``name`` if it is a name the benchmark may use as a file name; raises
    ``ValueError`` otherwise (a slash or ``..`` could lead out of the folder)."""
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


@dataclasses.dataclass(frozen=True)
class Cell:
    """One cell, with its configuration, traffic mix and the metrics
    ``BENCHMARK.json`` gives it."""

    name: str
    spec: Dict[str, Any]  # workloads/<name>.json
    config: Dict[str, Any]  # configs/<config>.json
    traffic: Dict[str, Any]  # traffic/<traffic>.json
    end_to_end: List[Dict[str, Any]]  # BENCHMARK.json entries this cell reports
    per_layer: List[Dict[str, Any]]

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])

    @property
    def family(self) -> str:
        return self.config["family"]

    @property
    def mesh(self) -> str:
        """The mesh a cell on several cards runs over, as the port's
        ``MeshPlan.parse`` reads it (``fsdp=4``); "" on one card."""
        return str(self.spec.get("mesh", ""))


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` from its files. Raises ``KeyError`` for a cell
    ``BENCHMARK.json`` does not list, ``ValueError`` where its file and
    ``BENCHMARK.json`` disagree."""
    check_name(name)
    here = os.path.join(root, "benchmark")
    bench = benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    spec = _load_json(os.path.join(here, "workloads", f"{name}.json"))
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} is {spec[key]!r} in its file and "
                             f"{entry[key]!r} in BENCHMARK.json")
    config = _load_json(os.path.join(here, "configs", f"{check_name(spec['config'])}.json"))
    traffic = _load_json(os.path.join(here, "traffic", f"{check_name(spec['traffic'])}.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, spec, config, traffic, e2e, per_layer)


def family(name: str) -> ModuleType:
    """The driver of a model family: ``families/<name>.py``."""
    return importlib.import_module(f"benchmark.families.{check_name(name)}")


def metric_reader(name: str, root: str = ROOT) -> ModuleType:
    """The reader of one metric: ``metrics/<name>.py``, loaded by its path
    (a metric's name may hold dots). Its ``read(run)`` returns the value, or
    None where the run gave it nothing to read."""
    path = os.path.join(root, "benchmark", "metrics", f"{check_name(name)}.py")
    mod_name = "benchmark_metric_" + re.sub(r"\W", "_", name)
    loader = importlib.util.spec_from_file_location(mod_name, path)
    if loader is None or loader.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod


def peak(device_kind: str, key: str, root: str = ROOT) -> Optional[float]:
    """A published peak of the card named ``device_kind`` (``peaks.json``,
    matched by prefix), or None for a card the table lacks."""
    table = _load_json(os.path.join(root, "benchmark", "peaks.json"))["cards"]
    for prefix, peaks in table.items():
        if device_kind.startswith(prefix):
            return float(peaks[key])
    return None
