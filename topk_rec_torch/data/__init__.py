"""Fold, id-map, ``.dat``, ``.mfp`` and feature IO of the port, and the
synthetic folds of its tests (counterpart of ``topk_rec_tpu/data``)."""

from .dataset import Interactions, synthetic_features, synthetic_interactions
from .io import (
    load_features,
    load_id_map,
    load_inverse_id_map,
    parse_ratings,
    parser,
    read_dat,
    read_mfp,
    write_dat,
    write_mfp,
)

__all__ = [
    "load_id_map",
    "load_inverse_id_map",
    "parse_ratings",
    "read_dat",
    "write_dat",
    "load_features",
    "Interactions",
    "synthetic_interactions",
    "synthetic_features",
    "parser",
    "read_mfp",
    "write_mfp",
]
