"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: its ``file`` entry (``portbench/configs/<name>.json``);
* a traffic mix: ``portbench/traffic/<traffic>.json``, whose ``kind`` names
  the driver (``portbench/harness/drivers/<kind>.py``) that reads it;
* a per-layer metric: ``portbench/metrics/<name>.py``, whose
  ``read(trace)`` returns the value or None when the trace holds nothing
  to read.

So a configuration, a mix, a cell or a metric is added by adding files and
entries; no file here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = "portbench"


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    return _named(man["workloads"], name, "workload")


def config(man: dict, name: str, root: str = ROOT) -> dict:
    entry = _named(man["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, BENCH_DIR, "traffic", name + ".json")) as f:
        return json.load(f)


def driver(kind: str):
    """The module that runs a traffic mix of ``kind``."""
    return importlib.import_module(f"portbench.harness.drivers.{kind}")


def _lists(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def end_to_end(man: dict, cell: str) -> List[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in man["end_to_end"] if _lists(m, cell)]


def per_layer(man: dict, cell: str) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(man, cell)}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def reader(name: str, root: str = ROOT) -> Callable:
    """``read(trace)`` of the per-layer metric ``name``."""
    path = os.path.join(root, BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_inputs(man: dict, name: str, root: str = ROOT) -> Dict[str, dict]:
    """The workload entry, its configuration and its traffic mix."""
    w = workload(man, name)
    return {"workload": w, "config": config(man, w["config"], root),
            "traffic": traffic(w["traffic"], root)}
