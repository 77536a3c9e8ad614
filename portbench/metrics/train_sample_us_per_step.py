"""The sampler's host time per training step: the program's
``train.sample`` spans (the chunk's one sampler call, its syncs included)
over the profiled steps."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "train":
        return None
    if not spans.count(trace, "train.sample"):
        return None
    return 1e6 * spans.inclusive_s(trace, "train.sample") / trace.counts[
        "steps"]
