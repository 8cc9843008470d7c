"""Build the port's CUDA sources at first use and bind them with ctypes.

Each source under ``fsae_mpc_tpu_torch/csrc/`` is compiled by ``nvcc`` into
a plain C-ABI shared library under ``fsae_mpc_tpu_torch/build/`` (listed in
``.gitignore``).  The file name carries a hash of the source and the flags,
so an edit rebuilds; ``nvcc``'s ``-Xptxas -v`` report (registers, spills)
is kept beside each library as ``.log``.  :func:`build` starts one ``nvcc``
per missing source, all together.  Nothing here runs at import.

The kernel modules (``riccati``, ``condense``, ``chol``) each hold a
:class:`Library` with the C signatures of their entry points and one
:class:`Kernel` per entry point, whose ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("riccati.cu", "condense.cu", "chol.cu")
# no --use_fast_math: the factor kernels' NaN poison and IEEE division and
# square root are part of their contract
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def library_path(source: str) -> str:
    """Where the build of ``csrc/<source>`` goes."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build(*sources: str) -> list[str]:
    """Compile each of ``sources`` (names under ``csrc/``; default: all)
    whose build is missing, one ``nvcc`` process per source, started
    together.  Returns the libraries' paths in the order given."""
    sources = sources or SOURCES
    outs = [library_path(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not os.path.exists(o)]
    if not todo:
        return outs
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for src, out in todo:
        tmp = out + f".tmp{os.getpid()}"
        procs.append((out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        with open(out[:-3] + ".log", "w") as f:
            f.write(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(out)}: nvcc failed "
                          f"({proc.returncode}):\n{stderr[-4000:]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


@dataclasses.dataclass
class Kernel:
    """One CUDA entry point and its launch count."""

    name: str
    symbol: str
    replaces: str
    launches: int = 0


class Library:
    """The shared library of one source, loaded at its first launch.

    ``signatures`` maps each C symbol to its ``ctypes`` argument types
    (every entry point returns a ``cudaError_t`` as ``int``)."""

    def __init__(self, source: str, signatures: dict):
        self.source = source
        self.signatures = signatures
        self._lib = None
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build(self.source)[0])
                for sym, argtypes in self.signatures.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib

    def launch(self, kernel: Kernel, *args) -> None:
        """Launch ``kernel`` on ``torch.cuda.current_stream()``; tensors
        go as their data pointers.  Raises if the launch is refused."""
        fn = getattr(self._load(), kernel.symbol)
        stream = torch.cuda.current_stream().cuda_stream
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        err = fn(*conv, stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {kernel.name} failed to launch: "
                               f"cudaError {err}")
        kernel.launches += 1


def route(t: torch.Tensor, what: str) -> str:
    """``"ref"`` for a CPU tensor (the plain version), ``"cuda"`` for a
    CUDA tensor (the kernel); any other device raises."""
    if t.device.type == "cpu":
        return "ref"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no {what} kernel for device {t.device}")


def check_tensors(tensors: dict, shapes: dict) -> None:
    """Validate what a kernel accepts (one CUDA device, float32,
    contiguous, the given shapes); raise on anything else."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor on {dev}, got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernels take float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")


def empty(like: torch.Tensor, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype, device=like.device)
