"""Milliseconds of the E-solve per iteration: the extent of the program's
``cer.esolve`` spans (each to the end of the last device work it
launched), less that of the ``cer.gram`` span inside the first, over its
``cer.iter`` spans, in the profiled call."""

from portbench.harness import spans
from portbench.harness.launch_trace import extent_s


def read(trace):
    if trace is None or trace.kind != "iterate":
        return None
    iters = spans.count(trace, "cer.iter")
    if not iters or not spans.count(trace, "cer.esolve"):
        return None
    esolve = extent_s(trace, "cer.esolve") - extent_s(trace, "cer.gram")
    return 1e3 * esolve / iters
