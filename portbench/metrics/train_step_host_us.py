"""The host time of one training step: the mean of the program's
``train.step`` spans (gathers, autograd, the summed gradients, RMSProp)."""

from portbench.harness import spans


def read(trace):
    if trace is None or trace.kind != "train":
        return None
    n = spans.count(trace, "train.step")
    if not n:
        return None
    return 1e6 * spans.inclusive_s(trace, "train.step") / n
