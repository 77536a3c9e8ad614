"""Profiling hooks (counterpart of ``topk_rec_tpu/utils/profiling.py``):
a ``torch.profiler`` trace of a block of code, written as a Chrome trace,
and a samples/s counter.
"""

from __future__ import annotations

import contextlib
import os
import time
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


class Throughput:
    """Rolling samples/sec counter for training loops (host clock: the
    caller synchronises the card before reading a rate)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._samples = 0

    def add(self, n: int) -> None:
        self._samples += n

    @property
    def samples_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._samples / dt if dt > 0 else 0.0
