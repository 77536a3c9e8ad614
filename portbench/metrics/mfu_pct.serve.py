"""The whole served batch's share of the card's bf16 peak: its scoring
FLOPs (2 · users · items · d) over the window's time per batch."""

from portbench.harness.opcount import PEAK_BF16


def read(trace):
    if trace is None or trace.kind != "serve" or not trace.device:
        return None
    return (100.0 * trace.counts["flops_per_batch"]
            / trace.window["s_per_batch"] / PEAK_BF16)
