"""Build and load the port's CUDA kernels.

The sources under ``fastecc_tpu_torch/csrc/`` have a plain C interface, so
``nvcc`` compiles them in seconds into a shared library (no PyTorch
headers), loaded with ``ctypes``: one ``nvcc`` per source, all started
together (the log ends with each one's seconds), then one link. The build
happens on first use, into ``build/torch_kernels/`` at the repository
root, under a name that hashes the sources and flags, so an edited source
never loads a stale library.
Every pointer and the stream pass as ``c_void_p``; every entry returns
its ``cudaGetLastError()`` code, which the wrappers turn into an
exception.
"""

from __future__ import annotations

import concurrent.futures
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
SOURCES = ("col.cu", "row.cu", "lanes.cu", "microbench.cu")
HEADERS = ("gf.cuh", "regstages.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> argtypes (field, x, out, A, B, L, tables..., stream)
SIGNATURES = {
    # col.cu: (field, x, out, A, B, L, inverse, inner twiddles, seed, t0,
    # tr, stream)
    "fecc_col": [_I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    # (... tr, pcol, prow, stream)
    "fecc_col_pre": [_I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P,
                     _P],
    # (... tr, vec, stream)
    "fecc_col_vec": [_I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P],
    # (field, x, out, A, B, L, tw_inv, tw_fwd, seed, t0, tr, pcol, prow,
    # stream)
    "fecc_seam": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P],
    # row.cu: (field, x, out, A, B, L, inverse, inner twiddles, stream)
    "fecc_row": [_I, _P, _P, _I, _I, _I, _I, _P, _P],
    # (field, x, out, A, B, L, inverse, inner twiddles, vec, stream)
    "fecc_row_post": [_I, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # (field, x, out, A, B, L, inverse, inner twiddles, vec, mask, orig,
    # stream)
    "fecc_row_post_sel": [_I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # col.cu: (field, x, out, A, B, L, tw_inv, tw_fwd, seed, t0, tr, vec,
    # stream)
    "fecc_seam_vec": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P],
    # (field, x, out, A, B, L, inverse inner twiddles, seed, t0, tr,
    # stream), K1 on each half
    "fecc_col_wire16": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    # (field, x, out, A, B, L, tw_inv, tw_fwd, seed, t0, tr, pcol, prow,
    # stream), K2 on each half
    "fecc_seam_wire16": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P,
                         _P],
    # row.cu: (field, lo, hi, stored, bitmap, A, B, L, inner twiddles,
    # stream)
    "fecc_row_wire16": [_I, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    # lanes.cu: (field, x, out, k, L, lvl_i, lvl_f, tw_i, tw_f, mid,
    # stream)
    "fecc_pair_lanes": [_I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
    # (field, x, stored, bitmap, k, L, lvl_i, lvl_f, tw_i, tw_f, mid,
    # stream)
    "fecc_pair_lanes_wire16": [_I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                               _P],
    # microbench.cu: (x, out, n, stream)
    "fecc_copy": [_P, _P, ctypes.c_longlong, _P],
    # (variant, x, z, out, rows, depth, stream)
    "fecc_chain": [_I, _P, _P, _P, _I, _I, _P],
    # (field, x, out, c, L, inner twiddles, depth, stream)
    "fecc_fused_chain": [_I, _P, _P, _I, _I, _P, _I, _P],
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
    tmpdir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    log = []
    try:
        objs = [tmpdir / (Path(s).stem + ".o") for s in SOURCES]

        def compile_one(src: str, obj: Path):
            t = time.perf_counter()
            p = subprocess.run([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                                str(CSRC / src)], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            return p.returncode, p.stdout, time.perf_counter() - t
        with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
            done = list(pool.map(compile_one, SOURCES, objs))
        log.extend(out for _, out, _ in done)
        log.append("".join(f"[nvcc] {s} {sec:.1f} s\n"
                           for s, (_, _, sec) in zip(SOURCES, done)))
        for s, (code, out, _) in zip(SOURCES, done):
            if code != 0:
                raise RuntimeError(f"nvcc failed on {s} ({code}):\n{out}")
        lib = tmpdir / "lib.so"
        proc = subprocess.run([nvcc(), *ARCH, "-shared", "-o", str(lib),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{log[-1]}")
        os.replace(lib, target)        # atomic: no reader sees half a file
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return Build(target, time.perf_counter() - t0, "".join(log))


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
