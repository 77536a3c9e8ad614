"""Text preprocessing tools (counterpart of ``topk_rec_tpu/tools``)."""

from .text import lda_topics, tfidf_features

__all__ = ["tfidf_features", "lda_topics"]
