"""Fold, id-map, ``.dat`` and feature IO of the port (counterpart of
``topk_rec_tpu/data``)."""

from .dataset import Interactions
from .io import (
    load_features,
    load_id_map,
    parse_ratings,
    parser,
    read_dat,
    write_dat,
)

__all__ = [
    "Interactions",
    "load_features",
    "load_id_map",
    "parse_ratings",
    "parser",
    "read_dat",
    "write_dat",
]
