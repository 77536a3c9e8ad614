"""Host syncs of the ALS solver per iteration: the program's ``als.sync``
spans (the read of the Cholesky's failures, once a block) over its
``cer.iter`` spans, in the profiled call."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "iterate":
        return None
    iters = spans.count(trace, "cer.iter")
    if not iters:
        return None
    return spans.count(trace, "als.sync") / iters
