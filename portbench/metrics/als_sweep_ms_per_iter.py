"""Milliseconds of ALS half-sweeps per iteration: the program's
``als.half_sweep`` spans (both sides; each block of a sweep waits on the
card once, so a span holds its device work) over its ``cer.iter`` spans,
in the profiled call."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "iterate":
        return None
    iters = spans.count(trace, "cer.iter")
    if not iters:
        return None
    return 1e3 * spans.inclusive_s(trace, "als.half_sweep") / iters
