"""Build and load the port's native code: the CUDA kernels (nvcc) and the
host text parser (g++), each into a plain-C shared library of its own.

The CUDA sources under ``topk_rec_torch/csrc`` are compiled at first use,
one ``nvcc`` per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <obj> csrc/<source>.cu

then linked with ``nvcc ... -shared`` into one
``<build>/<hash>/libtkr_kernels.so``, which is loaded with ``ctypes``. The
build directory is keyed on a hash of the sources (``*.cu`` and ``*.cuh``)
and the flags, so an edited source is rebuilt and an unchanged one is
reused. The library's entry points take pointers and the stream as
``c_void_p`` and return a ``cudaError_t`` value, which the wrappers turn
into an exception.

The host parser ``csrc/io_native.cpp`` (folds, ``.dat`` text) is compiled
at its first use with ``g++ -O3 -Wall -fPIC -std=c++17 -shared`` into
``<build>/<hash>/libtkr_io.so``, keyed the same way; it needs no CUDA and
never waits on ``nvcc``. Nothing here runs at import time: the tests import
every module, and a machine without a card has no ``nvcc``.
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
HOST_SOURCE = os.path.join(CSRC, "io_native.cpp")
GXX_FLAGS = ["-O3", "-Wall", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_host_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest(flags, paths) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in paths:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


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
    return _digest(NVCC_FLAGS, _sources()
                   + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))


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
            pi = ctypes.POINTER(ci)
            lib.tkr_topk_fused.argtypes = [vp] * 8 + [ci] * 8 + [vp]
            lib.tkr_count_vs_threshold.argtypes = [vp] * 7 + [ci] * 7 + [vp]
            lib.tkr_topk_floor.argtypes = [vp] * 8 + [ci] * 7 + [vp]
            lib.tkr_topk_geometry.argtypes = [ci] * 3 + [pi] * 3
            lib.tkr_count_geometry.argtypes = [ci] * 2 + [pi] * 3
            lib.tkr_floor_geometry.argtypes = [ci] * 2 + [pi] * 3
            lib.tkr_topk_max_d.argtypes = []
            for name in ("tkr_topk_fused", "tkr_count_vs_threshold",
                         "tkr_topk_floor", "tkr_topk_geometry",
                         "tkr_count_geometry", "tkr_floor_geometry",
                         "tkr_topk_max_d"):
                getattr(lib, name).restype = ci
            lib.tkr_error_string.argtypes = [ci]
            lib.tkr_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _build_host() -> str:
    out_dir = os.path.join(BUILD_ROOT, _digest(GXX_FLAGS, [HOST_SOURCE]))
    so = os.path.join(out_dir, "libtkr_io.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH")
    work = tempfile.mkdtemp(dir=out_dir)
    try:
        tmp = os.path.join(work, "libtkr_io.so")
        cmd = [cxx, *GXX_FLAGS, "-o", tmp, HOST_SOURCE]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(" ".join(cmd) + "\n" + res.stderr[-4000:])
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def load_host_library() -> ctypes.CDLL:
    """Build (if needed) and load the host parser library; cached per
    process. Raises RuntimeError or OSError if it cannot be built or
    loaded."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            _host_lib = ctypes.CDLL(_build_host())
        return _host_lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = load_library().tkr_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
