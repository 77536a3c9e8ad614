"""The port's models (counterpart of ``topk_rec_tpu/models``): BPR, VBPR,
WMF and CER."""

from .base import Recommender
from .bpr import BPR
from .cer import CER
from .vbpr import VBPR
from .wmf import WMF

__all__ = ["Recommender", "BPR", "VBPR", "WMF", "CER"]
