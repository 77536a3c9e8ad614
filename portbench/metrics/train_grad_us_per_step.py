"""Autograd's host time per training step: the program's ``train.grad``
spans (the loss and ``torch.autograd.grad``) over the profiled steps."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "train":
        return None
    if not spans.count(trace, "train.grad"):
        return None
    return 1e6 * spans.inclusive_s(trace, "train.grad") / trace.counts[
        "steps"]
