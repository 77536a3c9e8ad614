"""Conjugate-gradient steps of the E-solve per iteration: the program's
``cer.cg_step`` spans over its ``cer.iter`` spans, in the profiled call."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "iterate":
        return None
    iters = spans.count(trace, "cer.iter")
    if not iters:
        return None
    return spans.count(trace, "cer.cg_step") / iters
