"""The whole step's share of the card's fp32 peak: the model's FLOPs per
sample (``harness/opcount.py``) times the window's samples per second."""

from portbench.harness.opcount import PEAK_FP32


def read(trace):
    if trace is None or trace.kind != "train" or not trace.device:
        return None
    w = trace.window
    return 100.0 * w["flops_per_sample"] * w["samples_per_s"] / PEAK_FP32
