"""Device records (kernels, copies, fills) per training step, over the
profiled chunks, where they move the device's step time."""


def read(trace):
    if trace is None or trace.kind != "train" or not trace.device:
        return None
    return len(trace.device) / trace.counts["steps"]
