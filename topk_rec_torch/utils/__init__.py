"""Logging helpers of the port (counterpart of ``topk_rec_tpu/utils``)."""

from .logging import tprint
from .statelog import StateLog

__all__ = ["tprint", "StateLog"]
