"""Late fusion of per-modality models (counterpart of
``topk_rec_tpu/fusion``)."""

from .fusion import (
    ModalityScores,
    average_weights,
    bpr_fusion_weights,
    error_weights,
    evaluate_fused,
    rank_geometric_weights,
    svm_fusion_weights,
)

__all__ = [
    "ModalityScores",
    "average_weights",
    "rank_geometric_weights",
    "error_weights",
    "svm_fusion_weights",
    "bpr_fusion_weights",
    "evaluate_fused",
]
