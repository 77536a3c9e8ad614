"""Host syncs per training chunk: the program's ``train.sync`` spans (one
around each statement of the sampler that waits on the card) over its
``train.chunk`` spans."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "train":
        return None
    chunks = spans.count(trace, "train.chunk")
    if not chunks:
        return None
    return spans.count(trace, "train.sync") / chunks
