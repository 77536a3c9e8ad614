"""E-solves run as the direct fallback per call of ``CER.train``: the
program's ``cer.esolve_direct`` spans over the profiled calls (0 where CG
converges every iteration)."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "iterate":
        return None
    if not spans.count(trace, "cer.iter"):
        return None
    return spans.count(trace, "cer.esolve_direct") / trace.counts["calls"]
