"""Finds every piece of a cell by its name in ``BENCHMARK.json``.

- ``BENCHMARK.json`` (the root of the checkout): the cells, their
  configurations and chips, and which metrics each cell reports;
- ``perfbench/workloads/<cell>.json``: the kind of traffic, its parameters (``params``),
  the limits of the output check, and why the cell exists;
- the configuration's ``file`` (``perfbench/configs/<config>.json``);
- ``perfbench/traffic/<kind>.py``: the code that drives that kind of traffic;
- ``perfbench/metrics/<metric>.py``: the reader of each metric.

A later change adds a cell, a configuration or a metric as new files and
entries; no existing file needs an edit.
"""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Registry:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.bench["paths"][0]

    def cell(self, name: str) -> dict:
        """The cell file, with its ``BENCHMARK.json`` entry laid over it. A
        cell with a file and no entry yet runs too (it reports ``setup_s``
        and its check), so a cell can be tried before it is listed."""
        spec = json.loads((self.dir / "workloads" / f"{name}.json").read_text())
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), {})
        return {**spec, "name": name, **entry}

    def config(self, name: str) -> dict:
        file = next((c["file"] for c in self.bench["configs"] if c["name"] == name),
                    f"{self.bench['paths'][0]}/configs/{name}.json")
        return json.loads((self.root / file).read_text())

    def traffic(self, kind: str):
        return importlib.import_module(f"perfbench.traffic.{kind}")

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a cell reports: its end-to-end metrics (trace
        off) or its per-layer metrics (trace on)."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys laid over it, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out
