"""`BENCHMARK.json` and the files it names, found by name.

A cell names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<mix>.json`).  The mix names its driver (`drivers/<driver>.py`),
the configuration its plain reference (`reference/<reference>.py`), and
each per-layer metric is read by `metrics/<metric>.py`.  Adding any of
them is adding files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

#: The benchmark's own directory and the checkout's root.
BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: str = ROOT) -> dict:
    entry = find(bench["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", name + ".json")) as f:
        return json.load(f)


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reference(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def metric_reader(name: str):
    """`metrics/<name>.py` (metric names may hold dots, so by path)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, group: str) -> list[dict]:
    """The metrics of `group` ("end_to_end" or "per_layer") that `cell`
    reports: those without a `workloads` list, and those that list it."""
    return [m for m in bench[group]
            if "workloads" not in m or cell in m["workloads"]]
