"""The evaluator per fold: the program's ``TKR_TIMING`` phases
``<scenario>_eval`` (K1, the fetch and the hit count), summed over the
window's calls, over the calls."""


def read(trace):
    if trace is None or trace.kind != "evaluate":
        return None
    return trace.window.get("score_s")
