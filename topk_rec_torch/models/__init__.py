"""The port's models (counterpart of ``topk_rec_tpu/models``): BPR, VBPR,
WMF, CER and DPM, and DPM's content encoders."""

from .base import Recommender
from .bpr import BPR
from .cer import CER
from .dpm import DPM
from .encoders import Encoder, MLPEncoder, SDAEEncoder
from .vbpr import VBPR
from .wmf import WMF

__all__ = ["Recommender", "BPR", "VBPR", "WMF", "CER", "DPM", "Encoder",
           "MLPEncoder", "SDAEEncoder"]
