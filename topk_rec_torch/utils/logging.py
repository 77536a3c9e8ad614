"""Timestamped log lines and a stopwatch (counterpart of
``topk_rec_tpu/utils/logging.py``)."""

from __future__ import annotations

import sys
import time
from datetime import datetime


def tprint(msg: str, *, file=None) -> None:
    """Print a message prefixed with a microsecond timestamp."""
    stamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")
    print(f"{stamp}: {msg}", file=file or sys.stdout, flush=True)


class Timer:
    """Context-manager stopwatch: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self.start
