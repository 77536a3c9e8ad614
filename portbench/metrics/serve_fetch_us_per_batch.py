"""Host time per served batch in the program's ``serve.fetch`` spans (the
reads of the results into host memory, which wait on the card), over the
profiled batches."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "serve":
        return None
    if not spans.count(trace, "serve.fetch"):
        return None
    seconds = spans.inclusive_s(trace, "serve.fetch")
    return 1e6 * seconds / trace.counts["batches"]
