"""What the benchmark runs, found by name: ``BENCHMARK.json`` at the
checkout's root, and the files it names under ``benchmark/``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own, found by its name:

* ``benchmark/configs/<config>.json``: the model and its data (the
  entry's ``file``);
* ``benchmark/workloads/<traffic>.json``: the traffic mix, parameters
  that the general drivers (``train_cell``, ``serve_cell``) read;
* ``benchmark/limits/<cell>.json``: the limit of each number the cell's
  correctness check compares;
* ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric,
  ``read(run) -> float | None``.

A later cell, mix or metric is added as files and entries, and no file
here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root``, and its files."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self.dir = os.path.join(root, "benchmark")

    def _named(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        """The configuration's file, as run."""
        entry = self._named("configs", name)
        with open(os.path.join(self.root, entry["file"])) as f:
            return json.load(f)

    def _json(self, sub: str, name: str) -> dict:
        with open(os.path.join(self.dir, sub, f"{name}.json")) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        return self._json("workloads", name)

    def limits(self, cell: str) -> Optional[Dict[str, float]]:
        """The cell's limits, or None where none are set yet."""
        try:
            return self._json("limits", cell)
        except FileNotFoundError:
            return None

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics of the cell: those that list it, and
        those that list no cells and move an end-to-end metric it
        reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if ("workloads" in m and cell in m["workloads"])
                or ("workloads" not in m and m["moves"] in moved)]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        """``read`` of ``benchmark/metrics/<metric>.py``."""
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        mod_name = "benchmark_metric_" + "".join(
            c if c.isalnum() else "_" for c in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def cache_dir(self) -> str:
        """Generated data and the graph cache, ignored by git."""
        return os.path.join(self.dir, "cache")
