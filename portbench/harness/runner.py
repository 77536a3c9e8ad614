"""The run of one cell: the device check, the driver, the metrics, the
import check and the result's line."""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from . import manifest
from .result import Outcome, line, print_checks

FORBIDDEN = ("jax", "jaxlib", "flax", "topk_rec_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metric_values(man: dict, cell: str, outcome: Outcome,
                  trace: bool, root: str) -> dict:
    """The cell's end-to-end metrics, or in a traced run its per-layer
    metrics (those whose reader finds something to read)."""
    out = {}
    if not trace:
        for m in manifest.end_to_end(man, cell):
            out[m["name"]] = {"value": outcome.metrics[m["name"]],
                              "unit": m["unit"]}
        return out
    for m in manifest.per_layer(man, cell):
        value = manifest.reader(m["name"], root)(outcome.trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv: Optional[List[str]] = None, t_start: float = 0.0) -> int:
    args = parse(argv)
    man = manifest.load()
    chips = manifest.workload(man, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    inp = manifest.cell_inputs(man, args.workload)
    outcome = manifest.driver(inp["traffic"]["kind"]).run(
        inp["config"], inp["traffic"], args.seed, args.seconds,
        bool(args.trace), device, t_start)
    bad = forbidden_modules()
    if bad:
        print("error: JAX or the JAX package was loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 4
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    breakdown = None
    if args.trace:
        dev["busy_s"] = outcome.trace.busy_s()
        dev["window_s"] = outcome.trace.wall_s
        breakdown = outcome.trace.breakdown()
    metrics = metric_values(man, args.workload, outcome, bool(args.trace),
                            manifest.ROOT)
    print_checks(outcome.checks)
    sys.stdout.flush()
    print(line(outcome, metrics, dev, breakdown))
    return 0
