"""K1's share of its roofline in the served batches: its bf16 bound
(``harness/opcount.py``) over the device time of its records
(``topk_pass1``, ``topk_merge``) in the profiled batches."""


def read(trace):
    if trace is None or trace.kind != "serve":
        return None
    k1 = trace.device_s("topk_pass1", "topk_merge")
    if k1 <= 0:
        return None
    return 100.0 * trace.counts["k1_bound_s"] / k1
