"""ctypes bindings of the port's C++ parser (``csrc/io_native.cpp``,
counterpart of ``topk_rec_tpu/native/io_native.py``):

  * ``parse_ratings`` — ratings-fold text -> (pos, seen) index arrays
  * ``parse_dat``     — ``.dat`` text matrix -> flat float32 values
  * ``write_dat``     — ``%f``-formatted text matrix writer

Each mirrors the Python implementation in ``data/io.py``, which is its
specification. The library is compiled with g++ at first use
(``ops/_build.py``); ``available()`` is False when that fails, and the
callers then run the Python parser.
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
