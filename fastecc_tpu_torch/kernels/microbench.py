"""On-card microbenchmarks: the port's counterpart of
``kernels/microbench.py``, measuring the H100's own roofline peaks.

  * :func:`hbm_stream_gbps` — device-memory read+write bandwidth from a
    copy (K13), a full-size and a quarter-size copy differenced so the
    fixed per-call cost cancels.
  * :func:`vpu_chain_gops` — u32 op throughput from a DEPENDENT chain of
    one step per element (K14), two chain depths differenced so launch
    and memory traffic cancel. The steps are the reference's variants:
    raw multiply and add, GF32 addmod, the Solinas and the generic REDC,
    their mask-select forms, the GF16 multiplies, and composites that
    permute rows inside a 512-row tile (an interleave, radix-2 / radix-4
    stages).
  * :func:`fused_stage_gops` — element-stages/s of `depth` chained
    c-point transforms on the register-stage engine of the passes (K15).
  * :func:`measure_peaks` — all of them, under the reference's keys, so
    the dict drops into ``utils.profiling``'s ``peaks=``.

Each kernel has a wrapper and a plain PyTorch version here: the wrapper
takes the plain version only for a CPU tensor; on a CUDA tensor it
launches its kernel (``csrc/microbench.cu``) or raises, and counts the
launch in :data:`LAUNCHES`. Names, tables and sizes are the reference's;
the measurement functions default to the card and raise without one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import gf, interop
from ..fields import FIELDS, GF16, GF32
from ..utils.timer import time_fn
from . import _build
from .ntt_mfa import _row_tw_on, row_pass_plain

_TL = 128          # lanes of every array: [rows, 128] u32
_TS = 512          # rows of a composite step's tile
_TR = 8            # the fused chain's rows per tile: [c, rows_tiles * 8, 128]

# Launches per kernel, counted by the wrappers where they launch.
LAUNCHES = {"K13_copy": 0, "K14_chain": 0, "K15_fused_chain": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# The chain steps (plain versions; int64 carriers, values in [0, 2^32)).
# Each keeps y in the range the next application needs.
# ---------------------------------------------------------------------------

_PP = (1 << 32) - GF32.p        # 2^32 - p


def _raw_mul(y, z):
    return gf._mul_wide(y, z)[1]


def _raw_add(y, z):
    return (y + z) & gf.MASK32


def _addmod_masksel(y, z):
    """The carry-trick addmod with the final select as mask arithmetic,
    s - (pp & -[no wrap])."""
    t = z + _PP
    s = (y + t) & gf.MASK32
    nw = (s >= t).to(torch.int64)
    return (s - (_PP & (-nw & gf.MASK32))) & gf.MASK32


def _mont_mul_masksel(y, z):
    """The Solinas mont_mul with every select as mask arithmetic."""
    hi, lo = gf._mul_wide(y, z)
    m = (-(lo + (lo << 20))) & gf.MASK32
    s20 = (m & 0xFFF) << 20
    mp_hi = (m - (m >> 12) - (m < s20).to(torch.int64)) & gf.MASK32
    carry = (lo != 0).to(torch.int64)
    t2 = (hi + carry + _PP) & gf.MASK32
    s = (mp_hi + t2) & gf.MASK32
    nw = (s >= t2).to(torch.int64)
    return (s - (_PP & (-nw & gf.MASK32))) & gf.MASK32


def _interleave(y, z):
    """One Stockham inter-stage relayout (even/odd halves stacked along a
    new axis, flattened back) plus one raw add that keeps the chain
    value-dependent."""
    h = y.shape[0] // 2
    return (torch.stack([y[:h], y[h:]], dim=1).reshape(y.shape) + z
            ) & gf.MASK32


def _stage_r2_gf32(y, z):
    h = y.shape[0] // 2
    lo, hi = y[:h], y[h:]
    even = gf.add(GF32, lo, hi)
    odd = gf.mont_mul(GF32, gf.sub(GF32, lo, hi), z[:h])
    return torch.stack([even, odd], dim=1).reshape(y.shape)


def _stage_r2_gf16(y, z):
    h = y.shape[0] // 2
    lo, hi = y[:h], y[h:]
    even = gf.add(GF16, lo, hi)
    odd = gf._mul_gf16_tw(gf.sub(GF16, lo, hi), z[:h])
    return torch.stack([even, odd], dim=1).reshape(y.shape)


def _make_stage_r4(field, mul):
    def step(y, z):
        q = y.shape[0] // 4
        zq = z[:q]
        q0, q1, q2, q3 = y[:q], y[q:2 * q], y[2 * q:3 * q], y[3 * q:]
        s0, s1 = gf.add(field, q0, q2), gf.add(field, q1, q3)
        d0 = gf.sub(field, q0, q2)
        d1 = mul(gf.sub(field, q1, q3), zq)
        o00 = gf.add(field, s0, s1)
        o10 = mul(gf.sub(field, s0, s1), zq)
        o01 = mul(gf.add(field, d0, d1), zq)
        o11 = mul(gf.sub(field, d0, d1), zq)
        return torch.stack([o00, o01, o10, o11], dim=1).reshape(y.shape)
    return step


_stage_r4_gf32 = _make_stage_r4(GF32, lambda a, b: gf.mont_mul(GF32, a, b))
_stage_r4_gf16 = _make_stage_r4(GF16, gf._mul_gf16_tw)

# The order is the kernel's variant index (csrc/microbench.cu Variant).
_VARIANTS = {
    "raw-mul": _raw_mul,
    "raw-add": _raw_add,
    "addmod": lambda y, z: gf.add(GF32, y, z),
    "addmod-masksel": _addmod_masksel,
    "solinas": lambda y, z: gf.mont_mul(GF32, y, z),
    "solinas-bcast": lambda y, z: gf.mont_mul(GF32, y, z),
    "solinas-masksel": _mont_mul_masksel,
    "generic": lambda y, z: gf.mont_mul(GF32, y, z, generic=True),
    "gf16": lambda y, z: gf._mul_gf16(y, z),
    "gf16-bcast": lambda y, z: gf._mul_gf16(y, z),
    "gf16-tw": lambda y, z: gf._mul_gf16_tw(y, z),
    "interleave": _interleave,
    "stage-r2": _stage_r2_gf32,
    "stage-r4": _stage_r4_gf32,          # 2 element-stages per step
    "stage-r2-gf16": _stage_r2_gf16,
    "stage-r4-gf16": _stage_r4_gf16,     # 2 element-stages per step
}
_VARIANT_CODE = {v: i for i, v in enumerate(_VARIANTS)}

# variants whose z operand is z[row, 0], broadcast along the lanes
_BCAST = {"solinas-bcast", "gf16-bcast", "gf16-tw", "stage-r2",
          "stage-r4", "stage-r2-gf16", "stage-r4-gf16"}

# chain steps that apply TWO butterfly stages to every element: their
# rate counts element-stages
_STAGES_PER_STEP = {"stage-r4": 2, "stage-r4-gf16": 2}

# the composites permute rows inside a 512-row tile and take the short
# chain
_COMPOSITE = {"interleave", "stage-r2", "stage-r4",
              "stage-r2-gf16", "stage-r4-gf16"}
_DEFAULT_DEPTH = 128
_COMPOSITE_DEPTH = 16

# The fused-chain rows of the peaks table: key -> fused_stage_gops config.
_FUSED_CONFIGS = {
    "fused_gf32_c2048_gops": dict(field_name="GF32", c=2048),
    "fused_gf32_c512_gops": dict(field_name="GF32", c=512),
    "fused_gf16_c256_gops": dict(field_name="GF16", c=256),
}

# the fused chain's longest transform (csrc/microbench.cu kFusedMaxLog: 2^11)
MAX_FUSED_LEN = 2048


def peak_key(variant: str) -> str:
    """The peaks-table key of a chain variant: dashes become underscores
    ('raw-mul' -> 'raw_mul_gops'), and the composites carry '_flat' to
    tell them from the fused rates."""
    suffix = "_flat_gops" if variant in _COMPOSITE else "_gops"
    return variant.replace("-", "_") + suffix


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def chain_plain(x: torch.Tensor, z: torch.Tensor, variant: str,
                depth: int) -> torch.Tensor:
    """``depth`` applications of ``_VARIANTS[variant]`` to x [rows, 128]
    with operand z [rows, 128] (z[row, 0] for the ``_BCAST`` variants);
    the composites act on each 512-row tile."""
    (y, w), u = gf._carried(x, z)
    rows = y.shape[0]
    # a tile's row on axis 0: [512, rows / 512, 128]
    y = y.reshape(rows // _TS, _TS, _TL).transpose(0, 1)
    w = w.reshape(rows // _TS, _TS, _TL).transpose(0, 1)
    if variant in _BCAST:
        w = w[..., :1]
    step = _VARIANTS[variant]
    for _ in range(depth):
        y = step(y, w)
    return gf._ret(y.transpose(0, 1).reshape(rows, _TL).contiguous(), u)


def fused_chain_plain(x: torch.Tensor, field, depth: int) -> torch.Tensor:
    """``depth`` forward c-point transforms along axis 0 of x [c, ...]:
    the passes' stages alone (``ntt_mfa.row_pass_plain``)."""
    (y,), u = gf._carried(x)
    for _ in range(depth):
        y = row_pass_plain(y, field)
    return gf._ret(y, u)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _on_card(x: torch.Tensor, name: str) -> bool:
    """True to launch the kernel (CUDA tensor), False for the plain
    version (CPU tensor); raises on any other device or layout."""
    if x.dtype != torch.uint32 or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous torch.uint32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def copy(x: torch.Tensor) -> torch.Tensor:
    """K13: a copy of the u32 tensor ``x`` (any shape)."""
    if not _on_card(x, "copy"):
        return x.clone()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.call("fecc_copy", x.data_ptr(), out.data_ptr(), x.numel(),
                    _stream(x))
        LAUNCHES["K13_copy"] += 1
    return out


def chain(x: torch.Tensor, z: torch.Tensor, variant: str,
          depth: int) -> torch.Tensor:
    """K14: ``depth`` dependent applications of ``variant``'s step to x
    [rows, 128] u32 with operand z of the same shape; rows % 512 == 0."""
    if variant not in _VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: "
                         f"{list(_VARIANTS)}")
    if (x.dim() != 2 or x.shape[1] != _TL or x.shape[0] % _TS
            or x.shape[0] == 0 or z.shape != x.shape or depth < 0):
        raise ValueError(f"chain: needs x and z [rows, {_TL}] with rows a "
                         f"positive multiple of {_TS} and depth >= 0, got "
                         f"{tuple(x.shape)}, {tuple(z.shape)}, {depth}")
    on_card = _on_card(x, "chain")
    if _on_card(z, "chain") != on_card or z.device != x.device:
        raise ValueError(f"chain: x on {x.device}, z on {z.device}")
    if not on_card:
        return chain_plain(x, z, variant, depth)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.call("fecc_chain", _VARIANT_CODE[variant], x.data_ptr(),
                    z.data_ptr(), out.data_ptr(), x.shape[0], depth,
                    _stream(x))
        LAUNCHES["K14_chain"] += 1
    return out


def fused_chain(x: torch.Tensor, field, depth: int) -> torch.Tensor:
    """K15: ``depth`` forward c-point transforms along axis 0 of x
    [c, ...] u32 (c a power of two in [2, 2048]), each on the passes'
    register-stage engine with the tile held on chip throughout."""
    c = x.shape[0] if x.dim() else 0
    if not (2 <= c <= MAX_FUSED_LEN and c & (c - 1) == 0) or depth < 0:
        raise ValueError(f"fused_chain: needs c a power of two in "
                         f"[2, {MAX_FUSED_LEN}] and depth >= 0, got "
                         f"{tuple(x.shape)}, {depth}")
    if not _on_card(x, "fused_chain"):
        return fused_chain_plain(x, field, depth)
    tw = _row_tw_on(field.name, c, False, str(x.device))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.call("fecc_fused_chain", 0 if field.use_mont else 1,
                    x.data_ptr(), out.data_ptr(), c, x.numel() // c,
                    tw.data_ptr(), depth, _stream(x))
        LAUNCHES["K15_fused_chain"] += 1
    return out


# ---------------------------------------------------------------------------
# Inputs and measurements.
# ---------------------------------------------------------------------------

def _arange_u32(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)


def chain_inputs(rows: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's chain operands: x = i & 0xFFFF and
    z = ((i * 2654435761) & 0xFFFF) | 1 over [rows, 128], which keep every
    variant's values in its field (GF32 < p, GF16 <= 0x10000)."""
    i = torch.arange(rows * _TL, dtype=torch.int64, device=device)
    x = (i & 0xFFFF).to(torch.int32).view(torch.uint32).reshape(rows, _TL)
    z = (((i * 2654435761) & 0xFFFF) | 1).to(torch.int32).view(
        torch.uint32).reshape(rows, _TL)
    return x, z


def solinas_edge_pairs(n_each: int = 40, seed: int = 0x5011
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Operand pairs (a, b), both below p, that reach every corner of the
    Solinas steps (``csrc/gf.cuh`` mul_solinas and its masksel form):
    every pair of nine edge words (0, 1, 2, p - 1, p - 2, 2^16, 2^20, 2^31,
    (p - 1) / 2); pairs whose product has a zero low word; and, from seeded
    random pairs, ``n_each`` on each side of every conditional step of both
    REDC forms: the reference's [m < (m & 0xFFF) << 20] and wrap of
    mp_hi + t2 (fastecc_tpu/gf.py mont_mul), the kernel's carry out of
    lo + (lo << 20) and borrow of hi - q. u32 arrays."""
    p, mask = GF32.p, (1 << 32) - 1
    rng = np.random.default_rng(seed)
    words = [0, 1, 2, p - 1, p - 2, 1 << 16, 1 << 20, 1 << 31, (p - 1) // 2]
    a = [u for u in words for _ in words]
    b = words * len(words)
    for i in (1, 4, 12, 16, 20, 28, 31):     # 2^i u * 2^(32 - i) v
        for _ in range(4):
            a.append((1 << i) * int(rng.integers(0, p >> i) | 1))
            b.append((1 << (32 - i)) * int(rng.integers(0, p >> (32 - i)) | 1))
    ra = rng.integers(0, p, 1 << 16, dtype=np.uint64)
    rb = rng.integers(0, p, 1 << 16, dtype=np.uint64)
    t = ra * rb                                 # < p^2 < 2^64
    lo, hi = t & np.uint64(mask), t >> np.uint64(32)
    m = (np.uint64(1 << 32) - (lo + (lo << np.uint64(20))) % np.uint64(
        1 << 32)) & np.uint64(mask)
    s20 = (m & np.uint64(0xFFF)) << np.uint64(20)
    under = m < s20
    mp_hi = (m - (m >> np.uint64(12)) - under) & np.uint64(mask)
    t2 = (hi + (lo != 0) + np.uint64((1 << 32) - p)) & np.uint64(mask)
    wrap = ((mp_hi + t2) & np.uint64(mask)) < t2
    sh = (lo << np.uint64(20)) & np.uint64(mask)
    mk = (lo + sh) & np.uint64(mask)
    carry = mk < sh
    borrow = hi < mk - (mk >> np.uint64(12)) - carry
    for flag in (under, wrap, carry, borrow):
        for side in (flag, ~flag):
            idx = np.flatnonzero(side)[:n_each]
            a.extend(ra[idx].tolist())
            b.extend(rb[idx].tolist())
    return np.array(a, np.uint32), np.array(b, np.uint32)


def solinas_edge_inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """Chain operands x, z [512, 128] holding ``solinas_edge_pairs``:
    pair i at x[i, 0] and along row i of z (so the "-bcast" form, which
    takes z[i, 0], steps it too); every other word random below p."""
    a, b = solinas_edge_pairs()
    rng = np.random.default_rng(0x5012)
    x = rng.integers(0, GF32.p, (_TS, _TL), dtype=np.uint64).astype(np.uint32)
    z = np.repeat(rng.integers(0, GF32.p, (_TS, 1), dtype=np.uint64).astype(
        np.uint32), _TL, axis=1)
    x[:len(a), 0] = a
    z[:len(b)] = b[:, None]
    return interop.from_numpy_u32(x, device), interop.from_numpy_u32(z, device)


def fused_inputs(field, c: int, rows_tiles: int, device) -> torch.Tensor:
    """The reference's fused-chain input: i % min(p, 0x10000) over
    [c, rows_tiles * 8, 128]."""
    r_rows = rows_tiles * _TR
    i = torch.arange(c * r_rows * _TL, dtype=torch.int64, device=device)
    return (i % min(field.p, 0x10000)).to(torch.int32).view(
        torch.uint32).reshape(c, r_rows, _TL)


def hbm_stream_gbps(mib: int = 1024, iters: int = 3, device=None) -> float:
    """Copy bandwidth in GB/s counting read+write bytes, with the fixed
    per-call cost cancelled by differencing a full-size and a
    quarter-size copy."""
    dev = interop.resolve_device(device)
    rows = mib * 1024 * 1024 // (4 * _TL)
    t_small = time_fn(copy, _arange_u32(rows // 4 * _TL, dev), iters=iters)
    t_big = time_fn(copy, _arange_u32(rows * _TL, dev), iters=iters)
    marginal = max(t_big - t_small, 1e-9)
    return 2 * (rows - rows // 4) * _TL * 4 / marginal / 1e9


def vpu_chain_gops(variant: str, mib: int = 64, depth: int | None = None,
                   iters: int = 3, device=None) -> float:
    """Billions of ``variant`` steps/s (element-stages/s for the radix-4
    stages): depth against 2 * depth differenced, so launch overhead and
    the memory traffic cancel and only the marginal ``depth`` steps are
    timed. ``depth=None`` takes the variant's default (the composites run
    a short chain)."""
    if variant not in _VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    dev = interop.resolve_device(device)
    if depth is None:
        depth = _COMPOSITE_DEPTH if variant in _COMPOSITE else _DEFAULT_DEPTH
    rows = mib * 1024 * 1024 // (4 * _TL)
    x, z = chain_inputs(rows, dev)
    t1 = time_fn(chain, x, z, variant, depth, iters=iters)
    t2 = time_fn(chain, x, z, variant, 2 * depth, iters=iters)
    marginal = max(t2 - t1, 1e-9)
    mult = _STAGES_PER_STEP.get(variant, 1)
    return rows * _TL * depth * mult / marginal / 1e9


def fused_stage_gops(field_name: str = "GF32", c: int = 2048,
                     rows_tiles: int = 64, depth: int = 2, iters: int = 3,
                     device=None) -> float:
    """Element-stages/s of ``depth`` chained c-point transforms on the
    passes' register-stage engine, depth against 2 * depth differenced so
    memory and launch cancel: elems * log2(c) * depth / marginal."""
    dev = interop.resolve_device(device)
    field = FIELDS[field_name]
    x = fused_inputs(field, c, rows_tiles, dev)
    t1 = time_fn(fused_chain, x, field, depth, iters=iters)
    t2 = time_fn(fused_chain, x, field, 2 * depth, iters=iters)
    marginal = max(t2 - t1, 1e-9)
    return x.numel() * math.log2(c) * depth / marginal / 1e9


def measure_peaks(iters: int = 3, quick: bool = False, device=None) -> dict:
    """The peaks table: every key ``utils.profiling`` reads, and the
    chain and fused diagnostics, under the reference's names and at its
    sizes (a 1024 MiB copy, 64 MiB chains, 64 row tiles; ``quick``: 128,
    16 and 16)."""
    dev = interop.resolve_device(device)
    mib = 16 if quick else 64
    out = {"hbm_stream_gbps": round(hbm_stream_gbps(
        mib=128 if quick else 1024, iters=iters, device=dev), 1)}
    for v in _VARIANTS:
        out[peak_key(v)] = round(
            vpu_chain_gops(v, mib=mib, iters=iters, device=dev), 1)
    for key, cfg in _FUSED_CONFIGS.items():
        out[key] = round(fused_stage_gops(
            iters=iters, rows_tiles=16 if quick else 64, device=dev, **cfg),
            1)
    return out
