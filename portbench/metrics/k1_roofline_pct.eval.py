"""K1's share of its roofline in an evaluated fold: its fp32 bound over
each scenario's candidates, the items the protocol needs
(``harness/opcount.py``), over the device time of its records in the
profiled fold."""


def read(trace):
    if trace is None or trace.kind != "evaluate":
        return None
    k1 = trace.device_s("topk_pass1", "topk_merge")
    if k1 <= 0:
        return None
    return 100.0 * trace.counts["k1_bound_s"] / k1
