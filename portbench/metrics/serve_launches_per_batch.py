"""Device records (kernels, copies, fills) per served batch, over the
profiled batches."""


def read(trace):
    if trace is None or trace.kind != "serve" or not trace.device:
        return None
    return len(trace.device) / trace.counts["batches"]
