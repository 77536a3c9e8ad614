"""ctypes bindings of the port's C++ parser (``csrc/io_native.cpp``,
counterpart of ``topk_rec_tpu/native/io_native.py``):

  * ``parse_ratings`` — ratings-fold text -> (pos, seen) index arrays
  * ``parse_likes``   — test-fold text -> each user's liked candidates
  * ``parse_dat``     — ``.dat`` text matrix -> flat float32 values
  * ``write_dat``     — ``%f``-formatted text matrix writer

Each mirrors the Python implementation in ``data/io.py`` (``parse_likes``:
``eval/protocol.py``'s ``load_test_likes``), which is its specification.
The library is compiled with g++ at first use (``ops/_build.py``);
``available()`` is False when that fails, and the callers then run the
Python parser.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        from ..ops._build import load_host_library

        lib = load_host_library()
        ll, pi = ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
        lib.tkr_parse_ratings.restype = ll
        lib.tkr_parse_ratings.argtypes = [
            ctypes.c_char_p,                  # path
            ctypes.POINTER(ctypes.c_char_p),  # uid strings
            ll,                               # n_users
            ctypes.POINTER(ctypes.c_char_p),  # iid strings
            ll,                               # n_items
            *[ctypes.POINTER(pi)] * 4,        # out pos_u/i, seen_u/i
            ctypes.POINTER(ll),               # out n_pos
            ctypes.POINTER(ll),               # out n_seen
        ]
        pll = ctypes.POINTER(ll)
        lib.tkr_parse_likes.restype = ll
        lib.tkr_parse_likes.argtypes = [
            ctypes.c_char_p,                  # path
            ctypes.c_char_p, ll, pll, ll,     # user keys, length, values, n
            ctypes.c_char_p, ll, pll, ll,     # candidate keys, ...
            *[ctypes.POINTER(pll)] * 3,       # out users, offsets, items
            pll, pll,                         # out n_users, n_items
        ]
        lib.tkr_free.argtypes = [ctypes.c_void_p]
        lib.tkr_write_dat.restype = ctypes.c_int
        lib.tkr_write_dat.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ll, ll,
        ]
        lib.tkr_parse_dat.restype = ll
        lib.tkr_parse_dat.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),  # out data
            ctypes.POINTER(ll),                               # out n_vals
            ctypes.POINTER(ll),                               # out n_rows
            ctypes.POINTER(ll),                               # out first_cols
        ]
        _LIB = lib
    except (RuntimeError, OSError, AttributeError):
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def parse_ratings(
    path: str, uids: Dict[str, int], iids: Dict[str, int]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    lib = _load()
    assert lib is not None
    # id maps are dense (value == line order): pass the raw id strings in
    # index order and let the C++ side build its own hash maps
    uid_arr = (ctypes.c_char_p * len(uids))()
    for s, idx in uids.items():
        uid_arr[idx] = s.encode()
    iid_arr = (ctypes.c_char_p * len(iids))()
    for s, idx in iids.items():
        iid_arr[idx] = s.encode()
    outs = [ctypes.POINTER(ctypes.c_int)() for _ in range(4)]
    n_pos = ctypes.c_longlong(0)
    n_seen = ctypes.c_longlong(0)
    rc = lib.tkr_parse_ratings(
        path.encode(), uid_arr, len(uids), iid_arr, len(iids),
        *(ctypes.byref(o) for o in outs),
        ctypes.byref(n_pos), ctypes.byref(n_seen),
    )
    if rc != 0:
        raise IOError(f"native parse_ratings failed for {path} (rc={rc})")
    sizes = [n_pos.value, n_pos.value, n_seen.value, n_seen.value]
    arrays = []
    for ptr, size in zip(outs, sizes):
        arr = np.ctypeslib.as_array(ptr, shape=(size,)).astype(np.int32,
                                                                copy=True)
        lib.tkr_free(ptr)
        arrays.append(arr)
    return tuple(arrays)


def _joined(ids: Dict[str, int], vals: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """A map as ``tkr_parse_likes`` takes it: the keys of ``ids`` joined by
    ``\\n``, and ``vals``, one int64 per key in the same order. A key that
    holds a ``\\n`` matches no id of a line, so it is left out with its
    value."""
    keys = list(ids)
    joined = "\n".join(keys)
    if joined.count("\n") > max(len(keys) - 1, 0):
        kept = np.array(["\n" not in k for k in keys], dtype=bool)
        joined = "\n".join(k for k, keep in zip(keys, kept) if keep)
        vals = vals[kept]
    return joined.encode(), vals


def parse_likes(
    path: str, uids: Dict[str, int], cand_ids: Dict[str, int]
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Test-fold text -> int64 ``(users, offsets, items)``: the users with
    a line, in order of their first; user ``users[n]``'s likes are
    ``items[offsets[n]:offsets[n + 1]]``, from its last line, each the
    position of its candidate in ``cand_ids``' order. None when the file is
    left to the caller's Python loop: it holds a byte that Python's text
    mode reads otherwise than this parser (non-ASCII, a lone ``\\r``,
    ``\\f`` ...), or it cannot be opened (the loop then raises Python's own
    error)."""
    lib = _load()
    assert lib is not None
    u_keys, u_vals = _joined(
        uids, np.fromiter(uids.values(), dtype=np.int64, count=len(uids)))
    c_keys, c_vals = _joined(cand_ids, np.arange(len(cand_ids),
                                                 dtype=np.int64))
    pll = ctypes.POINTER(ctypes.c_longlong)
    outs = [pll() for _ in range(3)]
    n_users = ctypes.c_longlong(0)
    n_items = ctypes.c_longlong(0)
    rc = lib.tkr_parse_likes(
        path.encode(),
        u_keys, len(u_keys), u_vals.ctypes.data_as(pll), len(u_vals),
        c_keys, len(c_keys), c_vals.ctypes.data_as(pll), len(c_vals),
        *(ctypes.byref(o) for o in outs),
        ctypes.byref(n_users), ctypes.byref(n_items),
    )
    if rc != 0:
        return None
    sizes = [n_users.value, n_users.value + 1, n_items.value]
    arrays = []
    for ptr, size in zip(outs, sizes):
        arrays.append(np.ctypeslib.as_array(ptr, shape=(size,)).copy())
        lib.tkr_free(ptr)
    return tuple(arrays)


def parse_dat(path: str) -> Tuple[np.ndarray, int, int]:
    """``.dat`` text matrix -> (flat float32, n_rows, first_cols). The
    caller (``data/io.py:read_dat``) validates the shape, so its messages
    are the Python parser's. Raises ValueError on a non-numeric token."""
    lib = _load()
    assert lib is not None
    data = ctypes.POINTER(ctypes.c_float)()
    n_vals = ctypes.c_longlong(0)
    n_rows = ctypes.c_longlong(0)
    first_cols = ctypes.c_longlong(0)
    rc = lib.tkr_parse_dat(
        path.encode(), ctypes.byref(data), ctypes.byref(n_vals),
        ctypes.byref(n_rows), ctypes.byref(first_cols),
    )
    if rc == 2:
        raise ValueError(
            f"{path}: malformed .dat — non-numeric value in the matrix"
        )
    if rc != 0:
        raise IOError(f"native parse_dat failed for {path} (rc={rc})")
    if n_vals.value == 0:
        flat = np.zeros((0,), dtype=np.float32)
    else:
        flat = np.ctypeslib.as_array(data, shape=(n_vals.value,)).astype(
            np.float32, copy=True
        )
    if bool(data):
        lib.tkr_free(data)
    return flat, n_rows.value, first_cols.value


def write_dat(path: str, mat: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    rc = lib.tkr_write_dat(
        path.encode(),
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mat.shape[0],
        mat.shape[1],
    )
    return rc == 0
