"""Seconds per evaluated fold in the program's ``eval.count_hits`` spans
(the hit count on the host, its per-like bitmap loop included), over the
profiled folds."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "evaluate":
        return None
    if not spans.count(trace, "eval.count_hits"):
        return None
    return spans.inclusive_s(trace, "eval.count_hits") / trace.counts["folds"]
