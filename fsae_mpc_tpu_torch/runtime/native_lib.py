"""ctypes bindings of the native runtime, built on demand with ``g++``.

``runtime/native/{qp_activeset,csv_loader}.cpp`` compile into one shared
library under ``fsae_mpc_tpu_torch/build/`` whose name carries a hash of
the sources and flags, so an edit rebuilds.  The library is written under
a temporary name and renamed, so processes that build at once do not
read a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
SOURCES = ("qp_activeset.cpp", "csv_loader.cpp")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_lock = threading.Lock()


def library_path() -> str:
    """Where the build of the current sources goes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        with open(os.path.join(NATIVE_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfsae_native_{h.hexdigest()[:16]}.so")


def build_library(out: str) -> None:
    """Compile the sources with g++ into the shared library ``out``."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native runtime is built "
                           "with g++")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", tmp,
         *(os.path.join(NATIVE_DIR, s) for s in SOURCES)],
        capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{proc.stderr.strip()[-2000:]}")
    os.replace(tmp, out)


def load_native(build: bool = True) -> Optional[ctypes.CDLL]:
    """Load the native shared library, building it first if it is
    missing and ``build``; None if it cannot be had (a failed build is
    not tried again in this process)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            if not build or _build_failed:
                return None
            try:
                build_library(path)
            except (OSError, RuntimeError, subprocess.SubprocessError):
                _build_failed = True
                return None
        lib = ctypes.CDLL(path)
        dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.c_int
        lib.qp_solve_activeset.restype = ctypes.c_int
        lib.qp_solve_activeset.argtypes = (
            [ip, ip] + [dp] * 7 + [ip, dp, dp, ctypes.POINTER(ip)])
        lib.csv_read_matrix.restype = ctypes.c_int
        lib.csv_read_matrix.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(dp), ctypes.POINTER(ip),
            ctypes.POINTER(ip)]
        lib.csv_free.restype = None
        lib.csv_free.argtypes = [dp]
        _lib = lib
        return lib


def native_available() -> bool:
    return load_native() is not None


def _f64(a) -> np.ndarray:
    """A C-contiguous float64 numpy copy of an array or a CPU tensor."""
    if torch.is_tensor(a):
        if a.device.type != "cpu":
            raise ValueError("qp_solve_activeset takes numpy arrays or CPU "
                             f"tensors, not a tensor on {a.device}")
        a = a.detach().numpy()
    return np.ascontiguousarray(a, np.float64)


def _as_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def qp_solve_activeset(H, g, A, lb, ub, lbA, ubA, max_iter: int = 500):
    """Solve one dense QP

        min 1/2 x'Hx + g'x   s.t.  lb <= x <= ub,  lbA <= A x <= ubA

    in f64 with the native Goldfarb-Idnani active-set solver.  The inputs
    are numpy arrays or CPU tensors (H (n, n), A (m, n)).  Returns
    ``(x, objective, status)``: status 0 = optimal, 1 = iteration limit,
    2 = numerical failure, 3 = infeasible.
    """
    lib = load_native()
    if lib is None:
        raise RuntimeError("native library unavailable (build failed?)")
    H, g, A, lb, ub, lbA, ubA = map(_f64, (H, g, A, lb, ub, lbA, ubA))
    n, m = g.shape[0], lbA.shape[0]
    x = np.zeros(n)
    obj = ctypes.c_double(0.0)
    nact = ctypes.c_int(0)
    status = lib.qp_solve_activeset(
        n, m, _as_ptr(H), _as_ptr(g), _as_ptr(A), _as_ptr(lb), _as_ptr(ub),
        _as_ptr(lbA), _as_ptr(ubA), max_iter, _as_ptr(x),
        ctypes.byref(obj), ctypes.byref(nact))
    return x, obj.value, status


def read_matrix(path: str) -> np.ndarray:
    """Read a numeric CSV (one optional header line) through the native
    reader, as a float64 (rows, cols) array."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native library unavailable")
    data = ctypes.POINTER(ctypes.c_double)()
    rows, cols = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.csv_read_matrix(os.fsencode(path), ctypes.byref(data),
                             ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"csv_read_matrix({path}) failed with {rc}")
    try:
        out = np.ctypeslib.as_array(data,
                                    shape=(rows.value, cols.value)).copy()
    finally:
        lib.csv_free(data)
    return out
