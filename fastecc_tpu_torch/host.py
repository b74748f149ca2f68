"""ctypes binding of the native host data plane (``native/fastecc_host.cpp``):
the port's counterpart of ``host.py``.

The card owns the field math; this module owns the host-bound wire-format
work of the file layer: batch packing/unpacking of block files, parity
(de)serialization and CRC32C integrity tags, as OpenMP-parallel C++. The
storage layer calls it so that its emission threads issue no device work.

The C++ source is the reference's, read in place. :func:`build` compiles
it with ``g++`` (the flags of ``native/Makefile``) into
``build/torch_kernels/`` under a name that hashes the source, the flags
and the host's ``-march=native`` target, through a temporary file that is
``os.replace``-d into place: concurrent builds from several processes
never load a half-written library, and the reference's own
``build/libfastecc_host.so`` is never written or loaded.

Every function has a plain twin (``packing`` on a CPU tensor, and the
numpy CRC32C here) that gives the same bytes; :func:`available` reports
whether the native library is loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from . import packing
from .fields import FieldSpec

_REPO = Path(__file__).resolve().parent.parent
SOURCE = _REPO / "native" / "fastecc_host.cpp"
BUILD_DIR = _REPO / "build" / "torch_kernels"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-Wall", "-Wextra",
             "-shared", "-fPIC")

_LOCK = threading.Lock()
_lib = None


@functools.cache
def _target() -> Path | None:
    """The library's path: a hash of the source, the flags and the
    target ``-march=native`` selects on this host (a library built for
    one CPU is never loaded on another); None without a compiler."""
    try:
        isa = subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True,
                             check=True).stdout
    except (subprocess.CalledProcessError, OSError):
        return None
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(isa.encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastecc_host_{h.hexdigest()[:16]}.so"


def build(quiet: bool = True) -> bool:
    """Compile the native library unless this exact one exists, and load
    it. Returns True on success, False without a toolchain."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return True
        target = _target()
        if target is None:
            return False
        try:
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                   check=True, capture_output=quiet)
                    os.replace(tmp, target)   # atomic: no half-written file
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        except (subprocess.CalledProcessError, OSError):
            return False
    return _load()


def _load() -> bool:
    global _lib
    with _LOCK:
        if _lib is not None:
            return True
        target = _target()
        if target is None or not target.exists():
            return False
        try:
            _lib = _bind(ctypes.CDLL(str(target)))
        except (OSError, AttributeError):
            return False
        return True


def _bind(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64
    for name, args in [
        ("pack_gf32", (u8p, i64, u32p)),
        ("unpack_gf32", (u32p, i64, u8p)),
        ("serialize_parity_gf32", (u32p, i64, u8p)),
        ("deserialize_parity_gf32", (u8p, i64, u32p)),
        ("pack_gf16", (u8p, i64, u32p)),
        ("unpack_gf16", (u32p, i64, u8p)),
        ("serialize_parity_gf16", (u32p, i64, u8p)),
        ("deserialize_parity_gf16", (u8p, i64, u32p)),
        ("crc32c_blocks", (u8p, i64, i64, u32p)),
        ("ntt_mod", (u32p, u32p, i64, i64, u64, u64, u64)),
        ("mulmod_vec", (u32p, u32p, i64, u64, u32p)),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = None
    lib.crc32c.argtypes = [u8p, i64]
    lib.crc32c.restype = ctypes.c_uint32
    return lib


def available() -> bool:
    """Whether the native library is loaded (loading a built one)."""
    return _load()


def _native():
    if not _load():
        raise RuntimeError("native host library not built "
                           "(fastecc_tpu_torch.host.build())")
    return _lib


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _suffix(field: FieldSpec) -> str:
    return "gf32" if field.use_mont else "gf16"


def _check_width(a: np.ndarray, want: int, what: str) -> None:
    # The C++ functions hardcode the default 4 KB wire format: any other
    # width would read out of bounds or truncate blocks.
    if a.ndim != 2 or a.shape[1] != want:
        raise ValueError(
            f"native {what} is specialized to the default wire format "
            f"(width {want}); got {a.shape}: use packing for other block "
            f"sizes")


def pack_data(raw: np.ndarray, field: FieldSpec) -> np.ndarray:
    """[k, 4096] uint8 -> [k, lanes] uint32 (native batch pack)."""
    lib = _native()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    _check_width(raw, packing.BLOCK_BYTES, "pack_data")
    k = raw.shape[0]
    out = np.empty((k, packing.field_lanes(field)), dtype=np.uint32)
    getattr(lib, f"pack_{_suffix(field)}")(_u8p(raw), k, _u32p(out))
    return out


def unpack_data(fields: np.ndarray, field: FieldSpec) -> np.ndarray:
    """[k, lanes] uint32 -> [k, 4096] uint8 (native batch unpack)."""
    lib = _native()
    fields = np.ascontiguousarray(fields, dtype=np.uint32)
    _check_width(fields, packing.field_lanes(field), "unpack_data")
    k = fields.shape[0]
    out = np.empty((k, packing.BLOCK_BYTES), dtype=np.uint8)
    getattr(lib, f"unpack_{_suffix(field)}")(_u32p(fields), k, _u8p(out))
    return out


def serialize_parity(fields: np.ndarray, field: FieldSpec) -> np.ndarray:
    """[m, lanes] uint32 parity rows -> [m, parity_bytes] uint8."""
    lib = _native()
    fields = np.ascontiguousarray(fields, dtype=np.uint32)
    _check_width(fields, packing.field_lanes(field), "serialize_parity")
    m = fields.shape[0]
    out = np.empty((m, packing.parity_bytes(field)), dtype=np.uint8)
    getattr(lib, f"serialize_parity_{_suffix(field)}")(
        _u32p(fields), m, _u8p(out))
    return out


def deserialize_parity(raw: np.ndarray, field: FieldSpec) -> np.ndarray:
    """[m, parity_bytes] uint8 -> [m, lanes] uint32 parity rows."""
    lib = _native()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    _check_width(raw, packing.parity_bytes(field), "deserialize_parity")
    m = raw.shape[0]
    out = np.empty((m, packing.field_lanes(field)), dtype=np.uint32)
    getattr(lib, f"deserialize_parity_{_suffix(field)}")(
        _u8p(raw), m, _u32p(out))
    return out


def ntt(x: np.ndarray, field: FieldSpec, inverse: bool = False,
        scale: bool = True) -> np.ndarray:
    """NTT along axis 0 of [n, m] (or [n]) u32, native OpenMP path;
    bit-exact equal to ``ntt.ntt_host``."""
    lib = _native()
    x = np.ascontiguousarray(x, dtype=np.uint32)
    n = x.shape[0]
    m = int(np.prod(x.shape[1:], dtype=np.int64)) if x.ndim > 1 else 1
    out = x.copy()
    scratch = np.empty_like(out)
    w = field.root_of_order(n)
    if inverse:
        w = field.inv_host(w)
    s = field.inv_host(n) if (inverse and scale and n > 1) else 1
    if n > 1:
        lib.ntt_mod(_u32p(out), _u32p(scratch), n, m,
                    ctypes.c_uint64(field.p), ctypes.c_uint64(w),
                    ctypes.c_uint64(s))
    return out


def mulmod(a: np.ndarray, b: np.ndarray, field: FieldSpec) -> np.ndarray:
    """Elementwise (a * b) mod p, native path."""
    lib = _native()
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    if a.shape != b.shape:
        raise ValueError(f"mulmod: shapes {a.shape} and {b.shape} differ")
    out = np.empty_like(a)
    lib.mulmod_vec(_u32p(a), _u32p(b), a.size, ctypes.c_uint64(field.p),
                   _u32p(out))
    return out


@functools.cache
def _crc32c_table() -> np.ndarray:
    """Reflected-Castagnoli byte table (identical to the native one)."""
    tab = np.empty(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
        tab[i] = c
    tab.setflags(write=False)
    return tab


def crc32c_np(data: bytes | np.ndarray) -> int:
    """CRC32C in numpy; bit-identical to the native crc32c (so integrity
    checking never disappears without the toolchain)."""
    a = np.frombuffer(bytes(data), dtype=np.uint8)
    return int(crc32c_blocks_np(a.reshape(1, -1))[0])


def crc32c_blocks_np(blocks: np.ndarray) -> np.ndarray:
    """Per-row CRC32C in numpy: one vectorized table step per byte column,
    each over all rows at once."""
    tab = _crc32c_table()
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    crc = np.full(blocks.shape[0], 0xFFFFFFFF, dtype=np.uint32)
    for j in range(blocks.shape[1]):
        crc = tab[(crc ^ blocks[:, j]) & 0xFF] ^ (crc >> np.uint32(8))
    return crc ^ np.uint32(0xFFFFFFFF)


def crc32c(data: bytes | np.ndarray) -> int:
    """CRC32C of a byte string: native when loaded, numpy otherwise."""
    if not _load():
        return crc32c_np(data)
    a = np.frombuffer(bytes(data), dtype=np.uint8)
    return int(_lib.crc32c(_u8p(a), a.size))


def crc32c_blocks(blocks: np.ndarray) -> np.ndarray:
    """Per-row CRC32C tags of a [k, block_bytes] uint8 array (native
    OpenMP when loaded, vectorized numpy otherwise)."""
    if not _load():
        return crc32c_blocks_np(blocks)
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    tags = np.empty(blocks.shape[0], dtype=np.uint32)
    _lib.crc32c_blocks(_u8p(blocks), blocks.shape[0], blocks.shape[1],
                       _u32p(tags))
    return tags
