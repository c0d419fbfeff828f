"""The benchmark's description: BENCHMARK.json and the files it names.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by its name: `configs/<config>.json`,
`traffic/<traffic>.json`, `metrics/<metric>.py` (a reader with
`read(run) -> float | None`). Adding a cell or a metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


class Spec:
    """BENCHMARK.json, with lookups of a cell's configuration, traffic
    and metrics. `root` is the checkout (BENCHMARK.json) and `here` the
    benchmark's folder (configs/, traffic/, metrics/)."""

    def __init__(self, root=ROOT, here=HERE):
        self.root = root
        self.here = here
        self.doc = load_json(os.path.join(root, "BENCHMARK.json"))
        self.cells = {w["name"]: w for w in self.doc["workloads"]}
        self.configs = {c["name"]: c for c in self.doc["configs"]}

    def cell(self, name):
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return self.cells[name]

    def config(self, cell):
        entry = self.configs[cell["config"]]
        return load_json(os.path.join(self.root, entry["file"]))

    def traffic(self, cell):
        return load_json(os.path.join(self.here, "traffic",
                                      cell["traffic"] + ".json"))

    def metrics(self, cell, traced):
        """The metric entries a run of `cell` reports: the end-to-end ones
        without the trace, the per-layer ones with it; an entry with a
        `workloads` key only in the cells it lists."""
        group = self.doc["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def reader(self, metric_name):
        """The `read` function of metrics/<metric_name>.py."""
        path = os.path.join(self.here, "metrics", metric_name + ".py")
        mod_name = "avbench.metrics." + metric_name.replace(".", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
