"""The port's models (counterpart of ``topk_rec_tpu/models``): so far BPR."""

from .base import Recommender
from .bpr import BPR

__all__ = ["Recommender", "BPR"]
