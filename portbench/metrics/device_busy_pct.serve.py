"""The card's busy share of a served batch: the profiled batches' busy
device time per batch over the window's time per batch."""


def read(trace):
    if trace is None or trace.kind != "serve" or not trace.device:
        return None
    busy = trace.busy_s() / trace.counts["batches"]
    return 100.0 * busy / trace.window["s_per_batch"]
