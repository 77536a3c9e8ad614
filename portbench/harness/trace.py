"""A profiled stretch of the program: device records, busy time, breakdown.

``profiled(fn, device)`` runs ``fn`` under ``torch.profiler`` and returns a
:class:`Trace`: every device record (kernels, copies, fills) with its name,
start and length, the host's operations, and the stretch's wall time. The
per-layer metric readers (``portbench/metrics``) read it together with the
counts the driver adds (``counts``) and the unprofiled window's numbers
(``window``)."""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160  # a templated kernel's name is cut to its head


@dataclass
class Trace:
    kind: str                     # the traffic's kind: train, serve, evaluate
    wall_s: float                 # the profiled stretch, host clock
    device: List[Tuple[str, float, float]]   # (name, start s, length s)
    host: List[Tuple[str, float, float]]
    counts: Dict[str, float] = field(default_factory=dict)
    window: Dict[str, float] = field(default_factory=dict)

    def busy_s(self) -> float:
        """Seconds in which at least one device record ran."""
        if not self.device:
            return 0.0
        iv = sorted((s, s + d) for _, s, d in self.device)
        busy, (lo, hi) = 0.0, iv[0]
        for s, e in iv[1:]:
            if s > hi:
                busy += hi - lo
                lo, hi = s, e
            else:
                hi = max(hi, e)
        return busy + hi - lo

    def device_s(self, *names: str) -> float:
        """Summed length of the device records whose name holds one of
        ``names`` (all records without names)."""
        return sum(d for n, _, d in self.device
                   if not names or any(x in n for x in names))

    def breakdown(self) -> dict:
        """The device records that took most time, by name, and the idle
        gaps between records, summed by what the host was doing when each
        ended: the innermost profiled operation still running then, or
        host code outside any (Python, parsing)."""
        ops: Dict[str, float] = defaultdict(float)
        for n, _, d in self.device:
            ops[n] += d
        gaps: Dict[str, float] = defaultdict(float)
        if self.device and self.host:
            iv = sorted((s, s + d) for _, s, d in self.device)
            host = sorted(self.host, key=lambda e: e[1])
            starts = np.array([s for _, s, _ in host])
            reach = iv[0][1]
            for s, e in iv[1:]:
                if s > reach:
                    gaps[_host_at(host, starts, s)] += s - reach
                reach = max(reach, e)

        def top(d):
            return [[n[:NAME_CHARS], v] for n, v in
                    sorted(d.items(), key=lambda x: -x[1])[:BREAKDOWN_ENTRIES]]

        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


OUTSIDE = "host code outside torch ops"
LOOKBACK = 64  # host operations searched back for one still running


def _host_at(host, starts, t: float) -> str:
    """The name of the latest-started host operation running at ``t``."""
    at = int(np.searchsorted(starts, t, side="right")) - 1
    for k in range(at, max(at - LOOKBACK, -1), -1):
        name, start, length = host[k]
        if start + length >= t:
            return name
    return OUTSIDE


def profiled(kind: str, fn: Callable[[], None], device,
             host_ops: bool = True) -> Trace:
    """Run ``fn`` under the profiler, the device synchronised on both
    sides, and collect its records: the device's, and with ``host_ops``
    the host's operations."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    acts = (([ProfilerActivity.CPU] if host_ops or not on_card else [])
            + ([ProfilerActivity.CUDA] if on_card else []))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start * 1e-6,
               e.time_range.elapsed_us() * 1e-6)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(rec)
        else:
            host.append(rec)
    return Trace(kind, wall, dev, host)
