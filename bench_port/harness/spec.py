"""The benchmark's declarations, found by name: BENCHMARK.json at the root
of the checkout, and under bench_port/ one file per configuration
(configs/<config>.json), traffic mix (traffic/<traffic>.json), loop kind
(drivers/<driver>.py) and per-layer metric (metrics/<metric>.py).
Adding a configuration, a cell or a metric adds files; nothing here
changes."""
from __future__ import annotations

import importlib.util
import json
import os
import re

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_dir(root):
    """The benchmark's own folder inside the checkout `root`."""
    return os.path.join(root, os.path.basename(HERE))


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def applies(metric, cell_name):
    """Whether a metric entry of BENCHMARK.json is reported in the cell:
    every cell without a `workloads` key, else the cells it lists."""
    return "workloads" not in metric or cell_name in metric["workloads"]


class Cell:
    """One cell of BENCHMARK.json with everything it names: its
    configuration file, its traffic file, its driver and its metrics."""

    def __init__(self, root, name):
        self.root = root
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                           f"(cells: {', '.join(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.traffic_name = self.entry["traffic"]
        self.traffic = load_json(os.path.join(
            bench_dir(root), "traffic", self.traffic_name + ".json"))
        self.driver_name = self.traffic["driver"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]
        self.run_seconds = int(bench["run_seconds"])

    def driver(self):
        return load_module(os.path.join(bench_dir(self.root), "drivers",
                                        self.driver_name + ".py"),
                           "bench_driver_" + self.driver_name)

    def reader(self, metric_name):
        """The per-layer metric's reader: `read(trace) -> float | None`."""
        mod = load_module(os.path.join(bench_dir(self.root), "metrics",
                                       metric_name + ".py"),
                          "bench_metric_" + metric_name.replace(".", "_")
                          .replace("-", "_"))
        return mod.read


def load_module(path, module_name):
    """A module from a file path, whatever characters its file name has."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
