"""The card's busy share of a call of ``CER.train``: the profiled calls'
busy device time per call over the window's time per call."""


def read(trace):
    if trace is None or trace.kind != "iterate" or not trace.device:
        return None
    busy = trace.busy_s() / trace.counts["calls"]
    return 100.0 * busy / trace.window["s_per_call"]
