"""Seconds per evaluated fold in the program's ``io.read_dat`` spans (the
model's ``.dat`` tables parsed), over the profiled folds."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "evaluate":
        return None
    if not spans.count(trace, "io.read_dat"):
        return None
    return spans.inclusive_s(trace, "io.read_dat") / trace.counts["folds"]
