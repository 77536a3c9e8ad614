"""The whole call's share of the card's fp32 peak: the operations of the
window's calls (``harness/opcount_cer.py``, at the CG steps each E-solve
took) per second of the window."""

from portbench.harness.opcount import PEAK_FP32


def read(trace):
    if trace is None or trace.kind != "iterate" or not trace.device:
        return None
    return 100.0 * trace.window["flops_per_s"] / PEAK_FP32
