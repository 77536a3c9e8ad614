"""The whole step's share of the card's fp32 peak over the time the card
is busy: the model's FLOPs per step (``harness/opcount.py``) over the
profiled chunks' busy device time per step."""

from portbench.harness.opcount import PEAK_FP32


def read(trace):
    if trace is None or trace.kind != "train" or not trace.device:
        return None
    w = trace.window
    busy = trace.busy_s() / trace.counts["steps"]
    return 100.0 * w["flops_per_sample"] * w["batch"] / busy / PEAK_FP32
