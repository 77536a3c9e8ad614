"""In-memory interaction dataset with its derived layouts (counterpart of
``topk_rec_tpu/data/dataset.py``): CSR neighbour lists per user and per
item, for sampling and batched ALS solves, and packed membership bitmaps,
one bit per (user, item) positive or seen pair, for device-side negative
rejection and seen-item masking."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from .io import load_id_map, parse_ratings


def _csr(
    rows: np.ndarray, cols: np.ndarray, n_rows: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Sort (row, col) pairs into CSR (indptr, flat cols)."""
    order = np.argsort(rows, kind="stable")
    sorted_rows = rows[order]
    flat = np.ascontiguousarray(cols[order], dtype=np.int32)
    counts = np.bincount(sorted_rows, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return indptr, flat


def _bitmap(
    rows: np.ndarray, cols: np.ndarray, n_rows: int, n_cols: int
) -> np.ndarray:
    """Pack (row, col) membership into a uint32 bitmap [n_rows,
    ceil(n_cols/32)]: bit ``col & 31`` of word ``col >> 5``."""
    n_words = (n_cols + 31) // 32
    bm = np.zeros((n_rows, n_words), dtype=np.uint32)
    word = cols >> 5
    bit = np.uint32(1) << (cols & 31).astype(np.uint32)
    np.bitwise_or.at(bm, (rows, word), bit)
    return bm


@dataclass
class Interactions:
    """Implicit-feedback interactions for one training fold.

    ``pos_*`` are the like==1 training pairs; ``seen_*`` are all browsed
    pairs (used for evaluation-time exclusion). Derived layouts are built
    lazily and cached.
    """

    n_users: int
    n_items: int
    pos_u: np.ndarray  # int32 [nnz]
    pos_i: np.ndarray  # int32 [nnz]
    seen_u: Optional[np.ndarray] = None  # int32 [nnz_seen]
    seen_i: Optional[np.ndarray] = None
    _cache: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.seen_u is None:
            self.seen_u = self.pos_u
            self.seen_i = self.pos_i

    @classmethod
    def from_files(
        cls, uid_file: str, iid_file: str, tr_file: str
    ) -> Tuple["Interactions", Dict[str, int], Dict[str, int]]:
        """Load a fold from reference-format flat files."""
        uids = load_id_map(uid_file)
        iids = load_id_map(iid_file)
        pos_u, pos_i, seen_u, seen_i = parse_ratings(tr_file, uids, iids)
        inter = cls(len(uids), len(iids), pos_u, pos_i, seen_u, seen_i)
        return inter, uids, iids

    @property
    def nnz(self) -> int:
        return int(self.pos_u.shape[0])

    def _cached(self, key, builder):
        if key not in self._cache:
            self._cache[key] = builder()
        return self._cache[key]

    @property
    def user_indptr(self) -> np.ndarray:
        return self.user_csr[0]

    @property
    def user_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr [n_users+1], item indices [nnz]) of positives per user."""
        return self._cached(
            "user_csr", lambda: _csr(self.pos_u, self.pos_i, self.n_users)
        )

    @property
    def item_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr [n_items+1], user indices [nnz]) of positives per item."""
        return self._cached(
            "item_csr", lambda: _csr(self.pos_i, self.pos_u, self.n_items)
        )

    @property
    def user_deg(self) -> np.ndarray:
        return np.diff(self.user_csr[0]).astype(np.int32)

    @property
    def item_deg(self) -> np.ndarray:
        return np.diff(self.item_csr[0]).astype(np.int32)

    @property
    def rated_users(self) -> np.ndarray:
        """Users with at least one positive."""
        return np.nonzero(self.user_deg > 0)[0].astype(np.int32)

    @property
    def rated_items(self) -> np.ndarray:
        """Items with at least one positive."""
        return np.nonzero(self.item_deg > 0)[0].astype(np.int32)

    @property
    def pos_bitmap(self) -> np.ndarray:
        """uint32 [n_users, ceil(n_items/32)] positive-membership bitmap."""
        return self._cached(
            "pos_bitmap",
            lambda: _bitmap(self.pos_u, self.pos_i, self.n_users, self.n_items),
        )

    @property
    def seen_bitmap(self) -> np.ndarray:
        """uint32 bitmap of all browsed (user, item) pairs."""
        return self._cached(
            "seen_bitmap",
            lambda: _bitmap(self.seen_u, self.seen_i, self.n_users, self.n_items),
        )

    @property
    def item_like_counts(self) -> np.ndarray:
        """Per-item positive counts."""
        return np.bincount(self.pos_i, minlength=self.n_items).astype(np.int32)
