"""Milliseconds per call of ``CER.train`` outside its iterations: the
extents (each span to the end of the last device work it launched) of the
program's ``cer.features`` (F's upload), ``cer.gram`` (G = F·Fᵀ) and
``cer.writeback`` (the tables' read and the cold-start write-back) spans,
over the profiled calls."""

from portbench.harness import spans
from portbench.harness.launch_trace import extent_s

PARTS = ("cer.features", "cer.gram", "cer.writeback")


def read(trace):
    if trace is None or trace.kind != "iterate":
        return None
    if not spans.count(trace, "cer.writeback"):
        return None
    return 1e3 * sum(extent_s(trace, n) for n in PARTS) / trace.counts[
        "calls"]
