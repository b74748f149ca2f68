"""Build and load the port's CUDA kernels.

The sources under ``fastecc_tpu_torch/csrc/`` have a plain C interface, so
``nvcc`` compiles them in seconds into a shared library (no PyTorch
headers), loaded with ``ctypes``. The build happens on first use, into
``build/torch_kernels/`` at the repository root, under a name that hashes
the sources and flags, so an edited source never loads a stale library.
Every pointer and the stream pass as ``c_void_p``; every entry returns
its ``cudaGetLastError()`` code, which the wrappers turn into an
exception.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("ntt_mfa.cu",)
HEADERS = ("gf.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> argtypes (field, x, out, A, B, L, tables..., stream)
SIGNATURES = {
    "fecc_col": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    "fecc_col_pre": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P,
                     _P],
    "fecc_seam": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                  _P, _P],
    "fecc_row": [_I, _P, _P, _I, _I, _I, _P, _P, _P],
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float      # 0.0 when an identical library was already built
    log: str            # nvcc's output (ptxas register/shared-memory lines)


_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source on first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Build:
    """Compile the kernels unless this exact library exists; returns where
    it is, how long the compile took and nvcc's log."""
    target = BUILD_DIR / f"libfecc_ntt_{_digest()}.so"
    if target.exists():
        return Build(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)        # atomic: no reader sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Build(target, time.perf_counter() - t0, proc.stdout + proc.stderr)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build().path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.fecc_error_string.argtypes = [ctypes.c_int]
            lib.fecc_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def call(name: str, *args) -> None:
    """Launch C entry ``name``; raise if it reports a CUDA error."""
    lib = library()
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.fecc_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
