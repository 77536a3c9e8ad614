"""Timestamped log lines (counterpart of
``topk_rec_tpu/utils/logging.py``)."""

from __future__ import annotations

import sys
from datetime import datetime


def tprint(msg: str, *, file=None) -> None:
    """Print a message prefixed with a microsecond timestamp."""
    stamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")
    print(f"{stamp}: {msg}", file=file or sys.stdout, flush=True)
