"""Seconds per evaluated fold in the program's ``eval.fetch`` spans (the
results read into host memory once every chunk is queued), over the
profiled folds."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "evaluate":
        return None
    if not spans.count(trace, "eval.fetch"):
        return None
    return spans.inclusive_s(trace, "eval.fetch") / trace.counts["folds"]
