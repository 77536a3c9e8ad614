"""Host time per served batch in the program's ``k1.launch`` spans (K1's
host wrapper: its input checks, geometry, allocations and the launch
call), over the profiled batches."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "serve":
        return None
    if not spans.count(trace, "k1.launch"):
        return None
    seconds = spans.inclusive_s(trace, "k1.launch")
    return 1e6 * seconds / trace.counts["batches"]
