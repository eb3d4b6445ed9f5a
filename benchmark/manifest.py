"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root
of the checkout lists the cells and metrics; a cell's configuration,
traffic mix and limits, each entry point, each problem family's kind
module and each metric's reader are files of their own under this
folder, so that a cell, a metric or a problem family comes as new
files."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Callable, Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


class Cell:
    """One workload of the manifest with its configuration, traffic mix,
    correctness limits and metrics."""

    def __init__(self, name: str, bench: dict = None):
        bench = bench or manifest()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(cells)}")
        self.name = name
        self.spec = cells[name]
        cfgs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = cfgs[self.spec["config"]]
        self.config = _json(os.path.join(ROOT, self.config_entry["file"]))
        self.traffic = _json(os.path.join(
            HERE, "traffic", self.spec["traffic"] + ".json"))
        self.limits = _json(os.path.join(HERE, "limits", name + ".json"))
        self.chips = int(self.spec["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def reader(metric: str) -> Callable[[dict], object]:
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry(name: str):
    """The ``build`` function of ``entries/<name>.py``."""
    path = os.path.join(HERE, "entries", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_entry_" + name.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build


def kinds() -> list:
    """The kinds there are: the modules of ``kinds/``."""
    return sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "kinds"))
                  if f.endswith(".py") and not f.startswith("_"))


def kind(name: str):
    """The kind module ``kinds/<name>.py`` (``kinds/__init__.py`` says
    what it owns), imported by name so that spawn workers can run its
    ``make``; an unknown kind is refused, never given another kind's
    instances."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name) or name not in kinds():
        raise ValueError(f"no kind {name!r} in {os.path.join(HERE, 'kinds')}"
                         f"; there are {kinds()}")
    return importlib.import_module(f"{__package__}.kinds.{name}")


def overlay(base: Dict, over: Dict) -> Dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = overlay(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out
