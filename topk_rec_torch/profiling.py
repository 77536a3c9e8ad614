"""Profiling hook (counterpart of ``topk_rec_tpu/utils/profiling.py``):
a ``torch.profiler`` trace of a block of code, written as a Chrome trace,
with the program's ``tkr.*`` spans (``tracing.py``) among its host events.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block's host ops and, where a card is present, its CUDA
    kernels, and write ``log_dir/trace.json`` (open it in Perfetto or
    chrome://tracing). A no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
