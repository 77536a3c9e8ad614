"""A profiled stretch whose device records know when the host launched them.

``harness.trace.profiled`` keeps each device record's name, start and
length. :func:`profiled` here keeps, besides, the host time at which each
record was launched: the start of the CUDA runtime call
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) that the profiler gives
the record's id, its correlation id. The launches are known only where the
host's operations were profiled.

With them a span of the program can be given the device work it launched
(:func:`launched_s`), and its extent: from its start to the later of its
end and the end of the last record it launched (:func:`extent_s`). A span
that ends before its work has run on the card, as a product launched and
not waited for, is so given the time that work took."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch

from . import spans
from .trace import Trace


@dataclass
class LaunchTrace(Trace):
    # host time of each device record's launch (NaN: not known), in the
    # order of ``device``
    launched: List[float] = field(default_factory=list)


def profiled(kind: str, fn: Callable[[], None], device,
             host_ops: bool = True) -> LaunchTrace:
    """Run ``fn`` under the profiler, the device synchronised on both
    sides; with ``host_ops`` the host's operations and the launches too."""
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
    dev, host, dev_ids = [], [], []
    runtime = {}  # correlation id -> start of the runtime call
    for e in prof.events():
        rec = (e.name, e.time_range.start * 1e-6,
               e.time_range.elapsed_us() * 1e-6)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(rec)
            dev_ids.append(e.id)
            continue
        host.append(rec)
        # the runtime's calls; an operator's id is its own sequence
        if e.name.startswith("cu"):
            runtime.setdefault(e.id, rec[1])
    launched = [runtime.get(cid, math.nan) for cid in dev_ids]
    return LaunchTrace(kind, wall, dev, host, launched=launched)


def _records_in(trace, lo: float, hi: float) -> List[Tuple[float, float]]:
    """(start, end) of the device records launched in [lo, hi]."""
    return [(s, s + d) for (_, s, d), t in zip(
        trace.device, getattr(trace, "launched", [])) if lo <= t <= hi]


def has_launches(trace) -> bool:
    return any(not math.isnan(t)
               for t in getattr(trace, "launched", []))


def launched_s(trace, name: str, but: Optional[str] = None) -> float:
    """Summed device time of the records launched inside the spans named
    ``name``, less those launched inside a span named ``but``."""
    sp = spans.spans(trace)
    skip = [(s, e) for n, s, e in sp if n == but]
    total = 0.0
    for n, s, e in sp:
        if n != name:
            continue
        for (_, _, rd), t in zip(trace.device, trace.launched):
            if s <= t <= e and not any(a <= t <= b for a, b in skip):
                total += rd
    return total


def extent_s(trace, name: str) -> float:
    """Summed extent of the spans named ``name``: each from its start to
    the later of its end and the end of the last device record launched
    inside it."""
    total = 0.0
    for n, s, e in spans.spans(trace):
        if n == name:
            ends = [re for _, re in _records_in(trace, s, e)]
            total += max([e] + ends) - s
    return total

