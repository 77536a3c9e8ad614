"""The card's busy share of a training step: the profiled chunks' busy
device time per step over the window's CUDA-event time per step."""


def read(trace):
    if trace is None or trace.kind != "train" or not trace.device:
        return None
    busy = trace.busy_s() / trace.counts["steps"]
    return 100.0 * busy / trace.window["s_per_step"]
