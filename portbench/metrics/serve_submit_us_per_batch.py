"""Host time per served batch in the program's ``serve.submit`` spans
(``recommend_async``: the ids moved to the card, the kernel tables
checked, the gathers and K1's launch), over the profiled batches."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "serve":
        return None
    if not spans.count(trace, "serve.submit"):
        return None
    seconds = spans.inclusive_s(trace, "serve.submit")
    return 1e6 * seconds / trace.counts["batches"]
