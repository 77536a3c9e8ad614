"""The card's busy share of a fold: the profiled fold's busy device time
over the window's time per fold."""


def read(trace):
    if trace is None or trace.kind != "evaluate" or not trace.device:
        return None
    return 100.0 * trace.busy_s() / trace.window["s_per_fold"]
