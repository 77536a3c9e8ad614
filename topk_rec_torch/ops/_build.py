"""Build and load the port's CUDA kernels: nvcc into a plain-C shared library.

The sources under ``topk_rec_torch/csrc`` are compiled at first use, one
``nvcc`` per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <obj> csrc/<source>.cu

then linked with ``nvcc ... -shared`` into one
``<build>/<hash>/libtkr_kernels.so``, which is loaded with ``ctypes``. The
build directory is keyed on a hash of the sources (``*.cu`` and ``*.cuh``)
and the flags, so an edited source is rebuilt and an unchanged one is
reused. The library's entry points take pointers and the stream as
``c_void_p`` and return a ``cudaError_t`` value, which the wrappers turn
into an exception. Nothing here runs at import time: the CPU tests import
every module, and this machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (on PATH or under $CUDA_HOME/bin): the CUDA kernels "
        "of topk_rec_torch cannot be built"
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build() -> str:
    global build_seconds
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    so = os.path.join(out_dir, "libtkr_kernels.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    # a private directory: a concurrent build never sees these objects
    work = tempfile.mkdtemp(dir=out_dir)
    try:
        jobs = []
        for src in _sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )))
        failed = []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(" ".join(cmd) + "\n" + err[-4000:])
        tmp = os.path.join(work, "libtkr_kernels.so")
        if not failed:
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                   *(obj for _, obj, _ in jobs)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                failed.append(" ".join(cmd) + "\n" + res.stderr[-4000:])
        if failed:
            raise RuntimeError(
                "nvcc failed building topk_rec_torch kernels:\n"
                + "\n".join(failed)
            )
        os.replace(tmp, so)  # atomic: a loader never sees half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return so


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.tkr_topk_fused.argtypes = [vp] * 8 + [ci] * 8 + [vp]
            lib.tkr_topk_fused.restype = ci
            lib.tkr_count_vs_threshold.argtypes = [vp] * 7 + [ci] * 7 + [vp]
            lib.tkr_count_vs_threshold.restype = ci
            lib.tkr_topk_floor.argtypes = [vp] * 8 + [ci] * 7 + [vp]
            lib.tkr_topk_floor.restype = ci
            for name in ("tkr_topk_max_d", "tkr_topk_chunk"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = ci
            lib.tkr_error_string.argtypes = [ci]
            lib.tkr_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = load_library().tkr_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
