"""The whole fold's share of the card's fp32 peak: scoring every user
against each scenario's candidates (2 · users · candidates · d) over the
window's time per fold."""

from portbench.harness.opcount import PEAK_FP32


def read(trace):
    if trace is None or trace.kind != "evaluate" or not trace.device:
        return None
    w = trace.window
    return 100.0 * w["flops_per_fold"] / w["s_per_fold"] / PEAK_FP32
