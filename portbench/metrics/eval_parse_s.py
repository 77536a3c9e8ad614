"""Host IO per fold: the program's ``TKR_TIMING`` phases ``fold_parse``,
``dat_parse`` and each ``<scenario>_inputs``, summed over the window's
calls, over the calls."""


def read(trace):
    if trace is None or trace.kind != "evaluate":
        return None
    return trace.window.get("parse_s")
