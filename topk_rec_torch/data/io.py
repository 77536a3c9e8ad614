"""Flat-file IO: id vocabularies, ratings folds, ``.dat`` matrices and
pickled item features (counterpart of ``topk_rec_tpu/data/io.py``).

The port keeps its own copy so that it stands alone; the formats are the
reference's:

* id files (``uid`` / ``vid`` / ``*.idl``): one raw id per line; the index
  of an id is its line number.
* ratings folds (``f{n}tr.txt`` / ``f{n}te.{im,om}.txt``): lines of
  ``uid,iid:like,iid:like,...``; an interaction is a *positive* iff
  ``like == '1'``; every mentioned item counts as *browsed* history.
* ``final-U/V/B/E.dat``: row-major space-separated ``%f`` text matrices,
  row order = id-file order, written byte for byte as the reference's
  ``evaluate.py`` reads them.
* ``.mfp``: the reference solver's sparse rows, ``count id1 id2 ...``.

The C++ parser (``csrc/io_native.cpp``, bound in ``native/io_native.py``)
is built at first use; when it cannot be built or loaded, the NumPy
implementations below, which are its specification, run instead.
:func:`parser` says which one runs.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..tracing import span


def load_id_map(path: str) -> Dict[str, int]:
    """Map raw id string -> dense index (line order)."""
    ids: Dict[str, int] = {}
    with open(path, "r") as f:
        for line in f:
            tid = line.strip()
            ids[tid] = len(ids)
    return ids


def load_inverse_id_map(path: str) -> Dict[int, str]:
    """Map dense index -> raw id string (line order)."""
    ivt: Dict[int, str] = {}
    with open(path, "r") as f:
        for line in f:
            ivt[len(ivt)] = line.strip()
    return ivt


def parse_ratings(
    path: str,
    uids: Dict[str, int],
    iids: Dict[str, int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Parse a ratings fold file into int32 index arrays ``(pos_u, pos_i,
    seen_u, seen_i)``: the positives (``like == '1'``, both ids known) and
    every (user, item) mention regardless of like. Items unknown to
    ``iids`` are dropped from both sets."""
    native = _native_lib()
    if native is not None:
        return native.parse_ratings(path, uids, iids)
    pos_u: List[int] = []
    pos_i: List[int] = []
    seen_u: List[int] = []
    seen_i: List[int] = []
    with open(path, "r") as f:
        for line in f:
            terms = line.strip().split(",")
            uid = terms[0]
            if uid not in uids or len(terms) <= 1:
                continue
            u = uids[uid]
            for term in terms[1:]:
                iid, _, like = term.partition(":")
                i = iids.get(iid)
                if i is None:
                    continue
                seen_u.append(u)
                seen_i.append(i)
                if like == "1":
                    pos_u.append(u)
                    pos_i.append(i)
    return (
        np.asarray(pos_u, dtype=np.int32),
        np.asarray(pos_i, dtype=np.int32),
        np.asarray(seen_u, dtype=np.int32),
        np.asarray(seen_i, dtype=np.int32),
    )


def read_dat(path: str, ids: Optional[Dict[str, int]] = None) -> np.ndarray:
    """Read a space-separated text matrix (``final-*.dat``). Row order is
    id-file order, so ``ids`` only validates the row count."""
    with span("io.read_dat"):
        native = _native_lib()
        if native is not None:
            flat, n_rows, n_cols = native.parse_dat(path)
            if n_rows == 0:
                return np.zeros((0, 0), dtype=np.float32)
        else:
            with open(path, "r") as f:
                content = f.read()
            lines = content.splitlines()
            while lines and not lines[-1].strip():
                lines.pop()
            n_rows = len(lines)
            if n_rows == 0:
                return np.zeros((0, 0), dtype=np.float32)
            n_cols = len(lines[0].split())
            try:
                flat = np.array(content.split(), dtype=np.float32)
            except ValueError as e:
                raise ValueError(
                    f"{path}: malformed .dat — non-numeric value in the "
                    f"matrix ({e})"
                ) from None
        if n_cols == 0 or flat.size != n_rows * n_cols:
            raise ValueError(
                f"{path}: malformed .dat — expected a rectangular "
                f"space-separated float matrix ({n_rows} rows x {n_cols} "
                f"cols from the first row = {n_rows * n_cols} values, "
                f"found {flat.size})"
            )
        mat = flat.reshape(n_rows, n_cols)
        if ids is not None and len(ids) != n_rows:
            raise ValueError(
                f"{path}: expected {len(ids)} rows from id map, found "
                f"{n_rows}"
            )
        return mat


def write_dat(path: str, mat: np.ndarray) -> None:
    """Write a matrix in the reference's ``%f``-per-value text format: each
    line is ``%f %f ... %f \\n``, six-decimal fixed point with a trailing
    space before the newline."""
    parent = os.path.dirname(path)
    if parent and not os.path.isdir(parent):
        os.makedirs(parent, exist_ok=True)
    mat = np.asarray(mat)
    if mat.ndim == 1:
        mat = mat.reshape(-1, 1)
    native = _native_lib()
    if native is not None and native.write_dat(path, mat):
        return
    with open(path, "w") as f:
        for row in mat:
            f.write(" ".join("%f" % v for v in row))
            f.write(" \n")


def load_features(
    content_file: str,
    feat_id_file: str,
    item_ids: Dict[str, int],
    d: Optional[int] = None,
    dtype=np.float32,
) -> np.ndarray:
    """Load a pickled per-item feature matrix and align its rows to the
    training item order: the pickle holds one row per id in
    ``feat_id_file``; items missing from it get zero rows; scipy-sparse
    payloads are densified. ``d`` defaults to the pickle's width."""
    import scipy.sparse as ss

    fiids = load_id_map(feat_id_file)
    with open(content_file, "rb") as f:
        feat = pickle.load(f, encoding="latin1")
    if ss.issparse(feat):
        feat = feat.toarray()
    feat = np.asarray(feat, dtype=dtype)
    if d is None:
        d = feat.shape[1]
    out = np.zeros((len(item_ids), d), dtype=dtype)
    for iid, idx in item_ids.items():
        src = fiids.get(iid)
        if src is not None:
            out[idx, :] = feat[src, :]
    return out


def read_mfp(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read the legacy sparse ``.mfp`` format into CSR arrays: each line is
    ``count id1 id2 ...`` (the reference solver's user-major and
    item-major inputs). Returns (indptr [n_rows+1], flat ids [nnz]) int32."""
    indptr = [0]
    flat: List[int] = []
    with open(path, "r") as f:
        for line in f:
            terms = line.split()
            if not terms:
                continue
            count = int(terms[0])
            ids = [int(t) for t in terms[1 : 1 + count]]
            flat.extend(ids)
            indptr.append(len(flat))
    return (
        np.asarray(indptr, dtype=np.int32),
        np.asarray(flat, dtype=np.int32),
    )


def write_mfp(path: str, indptr: np.ndarray, flat: np.ndarray) -> None:
    """Write CSR arrays in the legacy ``.mfp`` format."""
    with open(path, "w") as f:
        for r in range(len(indptr) - 1):
            ids = flat[indptr[r]:indptr[r + 1]]
            f.write(str(len(ids)))
            for i in ids:
                f.write(f" {i}")
            f.write("\n")


_NATIVE = None
_NATIVE_CHECKED = False


def _native_lib():
    """The C++ parser module, or None when its library cannot be built or
    loaded (then the Python parser runs)."""
    global _NATIVE, _NATIVE_CHECKED
    if not _NATIVE_CHECKED:
        _NATIVE_CHECKED = True
        try:
            from ..native import io_native

            if io_native.available():
                _NATIVE = io_native
        except Exception:
            _NATIVE = None
    return _NATIVE


def parser() -> str:
    """``"native"`` when the C++ parser reads folds and ``.dat`` files,
    ``"python"`` when the NumPy one does."""
    return "native" if _native_lib() is not None else "python"
