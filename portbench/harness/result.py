"""What a run reports: the compared numbers with their limits, and the
result's last line."""

from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct only if ``value <= limit`` (a number that is not finite
    fails)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver measured and judged in one run."""
    metrics: Dict[str, float]          # end-to-end values by name
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    trace: Optional[object] = None     # harness.trace.Trace in a traced run

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(c.ok for c in self.checks))


def line(outcome: Outcome, metrics: Dict[str, dict], device: dict,
         breakdown: Optional[dict] = None) -> str:
    """The result's JSON line; the compared numbers come last."""
    out = {
        "correct": outcome.correct,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.checks}
    return json.dumps(out)


def print_checks(checks: List[Check], file=None) -> None:
    """Each compared number beside its limit, one a line."""
    file = file or sys.stderr
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=file)
    file.flush()
