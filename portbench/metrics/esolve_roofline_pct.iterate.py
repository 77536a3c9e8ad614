"""The E-solve's share of its roofline: its bound (``harness/opcount_cer.py``:
each E-solve's products at the CG steps it took) over the device time of
the records launched inside the program's ``cer.esolve`` spans, less those
launched inside ``cer.gram``, matched to their launch by correlation id,
in the profiled call."""

from portbench.harness import spans
from portbench.harness.launch_trace import has_launches, launched_s


def read(trace):
    if trace is None or trace.kind != "iterate" or not has_launches(trace):
        return None
    if not spans.count(trace, "cer.esolve"):
        return None
    busy = launched_s(trace, "cer.esolve", but="cer.gram")
    if busy <= 0:
        return None
    return 100.0 * trace.counts["esolve_bound_s"] / busy
