"""The window's training rate, read per layer where the cell's end-to-end
metric is the device's step time: every sample of every chunk of the
window over the window's time, as ``train_samples_per_s`` is taken."""


def read(trace):
    if trace is None or trace.kind != "train":
        return None
    return trace.window["samples_per_s"]
