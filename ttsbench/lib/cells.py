"""Finding a cell's pieces by name: its entry in ``BENCHMARK.json``, its file
``ttsbench/workloads/<cell>.json``, its configuration
``ttsbench/configs/<config>.json``, its traffic kind
``ttsbench/traffic/<kind>.py`` and each per-layer metric's reader
``ttsbench/metrics/<metric>.py``.  A new cell, configuration, kind or metric
is a new file and a new entry; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _module(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell: ``entry`` (its BENCHMARK.json line), ``spec`` (its file),
    ``config`` (its configuration file), ``kind`` (its traffic module) and
    its end-to-end and per-layer metric entries."""

    def __init__(self, name: str, bench_dir: str = BENCH_DIR, root: str = ROOT):
        bench = benchmark(root)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.spec = _json(os.path.join(bench_dir, "workloads", f"{name}.json"))
        for key in ("config", "traffic"):
            if self.spec[key] != self.entry[key]:
                raise ValueError(f"{name}: {key} {self.spec[key]!r} in its file, "
                                 f"{self.entry[key]!r} in BENCHMARK.json")
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(os.path.join(root, configs[self.entry["config"]]["file"]))
        self.kind = _module(os.path.join(bench_dir, "traffic", f"{self.spec['kind']}.py"),
                            f"ttsbench_kind_{self.spec['kind']}")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
        self.bench_dir = bench_dir

    def reader(self, metric: str):
        """The ``read(ctx)`` of a per-layer metric."""
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        return _module(path, "ttsbench_metric_" + metric.replace(".", "_").replace("-", "_")).read
