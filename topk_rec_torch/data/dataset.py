"""In-memory interaction dataset with its derived layouts (counterpart of
``topk_rec_tpu/data/dataset.py``): CSR neighbour lists per user and per
item, for sampling and batched ALS solves, and packed membership bitmaps,
one bit per (user, item) positive or seen pair, for device-side negative
rejection and seen-item masking."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from ..tracing import span
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
        with span("io.fold"):
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

    def dense_matrix(self, dtype=np.float32) -> np.ndarray:
        """Dense 0/1 positive matrix (tests / tiny data only)."""
        m = np.zeros((self.n_users, self.n_items), dtype=dtype)
        m[self.pos_u, self.pos_i] = 1
        return m


def synthetic_interactions(
    n_users: int,
    n_items: int,
    n_pos: int,
    seed: int = 0,
    latent_dim: int = 8,
    noise: float = 0.5,
) -> Interactions:
    """Implicit feedback with low-rank latent structure: users and items
    get latent vectors, and positives are drawn by a Gumbel-max over the
    noisy affinities, so factorization models learn a signal that top-k
    evaluation detects. The same NumPy draws as the JAX package's, so one
    seed gives the same arrays; the generating latents stay in
    ``_cache["u_lat"]`` and ``_cache["i_lat"]`` for
    :func:`synthetic_features`."""
    rng = np.random.default_rng(seed)
    u_lat = rng.normal(size=(n_users, latent_dim))
    i_lat = rng.normal(size=(n_items, latent_dim))
    pos_set = set()
    pos_u = np.empty(n_pos, dtype=np.int32)
    pos_i = np.empty(n_pos, dtype=np.int32)
    count = 0
    while count < n_pos:
        # capped draw batch: the [batch, n_items] affinity is the memory hog
        batch = min(65536, max(1024, (n_pos - count) * 2))
        us = rng.integers(0, n_users, size=batch)
        aff = u_lat[us] @ i_lat.T + noise * rng.normal(size=(batch, n_items))
        its = np.argmax(aff + rng.gumbel(size=aff.shape), axis=1)
        for u, i in zip(us, its):
            key = (int(u), int(i))
            if key not in pos_set:
                pos_set.add(key)
                pos_u[count] = u
                pos_i[count] = i
                count += 1
                if count == n_pos:
                    break
    inter = Interactions(n_users, n_items, pos_u, pos_i)
    inter._cache["u_lat"] = u_lat
    inter._cache["i_lat"] = i_lat
    return inter


def synthetic_features(
    inter: Interactions, d: int, seed: int = 0, noise: float = 0.3
) -> np.ndarray:
    """Item content features that predict preferences: a random linear
    embedding of the generating item latents plus noise when ``inter``
    came from :func:`synthetic_interactions` (so content models generalize
    to cold items), else a smoothed co-occurrence mix of random rows."""
    rng = np.random.default_rng(seed + 1)
    i_lat = inter._cache.get("i_lat")
    if i_lat is not None:
        proj = rng.normal(size=(i_lat.shape[1], d))
        feat = i_lat @ proj + noise * rng.normal(size=(inter.n_items, d))
        return feat.astype(np.float32)
    base = rng.normal(size=(inter.n_items, d)).astype(np.float32)
    co = inter.dense_matrix()
    item_profile = co.T @ co  # [n_items, n_items]
    norm = item_profile.sum(axis=1, keepdims=True)
    norm[norm == 0] = 1
    mixed = (item_profile / norm) @ base
    return (base + mixed).astype(np.float32)
