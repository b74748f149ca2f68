"""Fused four-step NTT passes: the port's counterpart of
``kernels/ntt_mfa.py``.

The matrix-Fourier decomposition N = C x R runs each transform as two
passes over device memory, each keeping a whole sub-transform on chip:

  pass A (column, K1 / K4): the [C, R, L] view; C-point Stockham stages
      along axis 0, x the four-step twiddle T[k_c, r] = w_N^(k_c * r)
      (N^-1 folded in for a scaled inverse), transposed write [R, C, L].
      K4 first multiplies x[m] *= g^m (m = r + R*c) from rank-1 tables.
  pass B (row, K3): R-point stages along axis 0 of [R, C, L]; the output
      is natural order (k = k_c + C*k_r, k_r-major).

The RS encode pair NTT_coset(iNTT(x)) runs in three passes: A1, the seam
(K2: transform 1's pass B, the coset multiply g^m, transform 2's pass A
in one residency) and B2. The seam needs transform 2 to take the swapped
split (c2, r2) = (r1, c1): transform 1's pass-B output column IS
transform 2's pass-A input column.

Each pass has a wrapper and a plain PyTorch version here. The wrapper
takes the plain version only for a CPU tensor; on a CUDA tensor it
launches its Hopper kernel (``csrc/ntt_mfa.cu``) or raises, and counts
the launch in :data:`LAUNCHES`. Split, lane tile and twiddle tables are
the port's own; the output bits are the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import gf
from ..fields import FieldSpec, FIELDS
from ..ntt import (_log2, _r4_twiddles, _stage_twiddles, mul_prepared, ntt,
                   powers_host, powers_outer_host, prepare_consts)
from . import _build

# Smallest transform order the kernels take: both factors of the split
# must be at least 2.
MIN_ORDER = 4
# Largest transform length along a pass's axis 0. The largest order either
# field has is 2^20 (GF32's two-adic order), which the splits below make
# 1024 x 1024 (single) and 512 x 1024 (pair).
MAX_PASS_LEN = 1 << 10

# Launches per kernel, counted by the wrappers where they launch.
LAUNCHES = {"K1_col": 0, "K2_seam": 0, "K3_row": 0, "K4_col_pre": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Host tables (numpy; copied from the reference).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _packed_stage_twiddles(field_name: str, c: int, inverse: bool):
    """All Stockham stage tables of a length-c transform, concatenated
    ([c/2] + [c/4] + ... + [1] = c-1 prepared values, zero-padded to c)."""
    parts = []
    a = c
    while a >= 2:
        parts.append(_stage_twiddles(field_name, a, inverse))
        a >>= 1
    parts.append(np.zeros(1, np.uint32))
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def _packed_w3_twiddles(field_name: str, c: int, inverse: bool):
    """Radix-4 side table w_a^(3j), j in [0, a/4), at the same offsets as
    the stage tables (each a/2-slot region holds a/4 values, zero-padded).
    w_a^j and i4 = w_a^(a/4) come from stage a's table, w_a^(2j) is stage
    a/2's table."""
    parts = []
    a = c
    while a >= 2:
        q = a // 4
        row = np.zeros(a // 2, np.uint32)
        if q >= 1:
            row[:q] = _r4_twiddles(field_name, a, inverse)[3]
        parts.append(row)
        a >>= 1
    parts.append(np.zeros(1, np.uint32))
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def _colpass_seeds(field_name: str, n: int, c: int, inverse: bool,
                   scale: bool, tr: int):
    """O(sqrt N) twiddle seeds for pass A: (seed_pows [C, tr], t0
    [R/tr, C]) with seed_pows[k_c, j] = prep(w_N^(k_c * j)) and
    t0[i, k_c] = prep(s * w_N^(k_c * i * tr)), s = N^-1 for a scaled
    inverse else 1. T[k_c, i*tr + j] = seed_pows[k_c, j] * t0[i, k_c]
    (prepared x prepared stays prepared)."""
    field = FIELDS[field_name]
    r_dim = n // c
    w = field.root_of_order(n)
    if inverse:
        w = field.inv_host(w)
    s = field.inv_host(n) if (inverse and scale) else 1
    seed_pows = powers_outer_host(field, powers_host(field, w, c), tr)
    bases = powers_host(field, field.pow_host(w, tr), r_dim // tr)
    t0 = powers_outer_host(field, bases, c)
    if s != 1:
        p64 = np.uint64(field.p)
        t0 = (t0.astype(np.uint64) * np.uint64(s % field.p)
              % p64).astype(np.uint32)
    return (np.asarray(prepare_consts(field, seed_pows)),
            np.asarray(prepare_consts(field, t0)))


@functools.lru_cache(maxsize=None)
def _pre_mul_tables(field_name: str, g_pre: int, c: int, r: int, tr: int):
    """Tables of the rank-1 input multiply x[m] *= g^m, m = r + R*c:
    g^m = (g^R)^c * g^r. Returns (pcol [C], prow [R/tr, 1, tr]),
    prepared."""
    field = FIELDS[field_name]
    pcol = powers_host(field, field.pow_host(g_pre, r), c)
    prow = powers_host(field, g_pre, r).reshape(r // tr, 1, tr)
    return (np.asarray(prepare_consts(field, pcol)),
            np.asarray(prepare_consts(field, prow)))


# ---------------------------------------------------------------------------
# The port's split and seed policy.
# ---------------------------------------------------------------------------

def _split(n: int) -> int:
    """C for a single transform: the balanced split, C >= R (at 2^20,
    1024 x 1024, so each pass's column fits a block's shared memory)."""
    return 1 << ((_log2(n) + 1) // 2)


def _pair_split(n: int) -> int:
    """C1 for the encode pair: the balanced split with the deeper factor
    in R1, which the seam holds through both of its transforms (2^19:
    C1 = 512, R1 = 1024). The seam takes C2 = R1, R2 = C1."""
    return 1 << (_log2(n) // 2)


def _seed_tr(r: int) -> int:
    """Seed width for the four-step tables: ~sqrt(R), so both tables are
    O(sqrt(R) * C)."""
    return 1 << (_log2(r) // 2)


def _check_order(x: torch.Tensor, n: int) -> None:
    if x.device.type == "cuda" and n < MIN_ORDER:
        raise ValueError(f"the CUDA transform needs order >= {MIN_ORDER}, "
                         f"got {n}")


# ---------------------------------------------------------------------------
# Device tables (u32 tensors, cached per device).
# ---------------------------------------------------------------------------

def _u32_on(arr: np.ndarray, device: str) -> torch.Tensor:
    a = np.ascontiguousarray(arr, dtype=np.uint32).reshape(-1)
    return torch.from_numpy(a.view(np.int32)).to(device).view(torch.uint32)


@functools.lru_cache(maxsize=None)
def _stage_tables_on(field_name: str, a: int, inverse: bool, device: str):
    return (_u32_on(_packed_stage_twiddles(field_name, a, inverse), device),
            _u32_on(_packed_w3_twiddles(field_name, a, inverse), device))


@functools.lru_cache(maxsize=None)
def _seeds_on(field_name: str, n: int, c: int, inverse: bool, scale: bool,
              tr: int, device: str):
    seed, t0 = _colpass_seeds(field_name, n, c, inverse, scale, tr)
    return _u32_on(seed, device), _u32_on(t0, device)


@functools.lru_cache(maxsize=None)
def _pre_on(field_name: str, g: int, c: int, r: int, tr: int, device: str):
    pcol, prow = _pre_mul_tables(field_name, g, c, r, tr)
    return _u32_on(pcol, device), _u32_on(prow, device)


# ---------------------------------------------------------------------------
# Plain versions of the passes (int64 carriers; any device).
# ---------------------------------------------------------------------------

def _twiddle_plain(y, field: FieldSpec, n: int, c: int, inverse: bool,
                   scale: bool, tr: int):
    """y [C, R, L] *= T[k_c, r] expanded from the seed tables."""
    r = n // c
    seed, t0 = _colpass_seeds(field.name, n, c, inverse, scale, tr)
    cols = torch.arange(r, device=y.device)
    s = gf.table(seed, y.device)[:, cols % tr]                # [C, R]
    t = gf.table(t0, y.device).T[:, torch.div(cols, tr,
                                              rounding_mode="floor")]
    return mul_prepared(field, y, mul_prepared(field, s, t)[:, :, None])


def _rank1_plain(x, field: FieldSpec, g: int, c: int, r: int):
    """x [C, R, L] *= g^(r + R*c) from the rank-1 tables."""
    pcol, prow = _pre_mul_tables(field.name, g % field.p, c, r, _seed_tr(r))
    pre = mul_prepared(field, gf.table(pcol, x.device)[:, None],
                       gf.table(prow.reshape(-1), x.device)[None, :])
    return mul_prepared(field, x, pre[:, :, None])


def col_pass_plain(x3: torch.Tensor, field: FieldSpec, inverse: bool = False,
                   scale: bool = True, pre_seed: int | None = None):
    """Plain pass A: [C, R, L] -> [R, C, L] (optionally with the rank-1
    prologue x[m] *= pre_seed^m)."""
    (x,), u = gf._carried(x3)
    c, r, _ = x.shape
    if pre_seed is not None:
        x = _rank1_plain(x, field, pre_seed, c, r)
    y = ntt(x, field, inverse=inverse, scale=False, radix=4)
    y = _twiddle_plain(y, field, c * r, c, inverse, scale, _seed_tr(r))
    return gf._ret(y.permute(1, 0, 2).contiguous(), u)


def seam_pass_plain(y1: torch.Tensor, field: FieldSpec, pre_seed2: int):
    """Plain seam: [R1, C1, L] -> [C1, R1, L]: inverse R1-point stages,
    x g^m, forward stages (C2 = R1), x T2, transpose."""
    (y,), u = gf._carried(y1)
    r1, c1, _ = y.shape
    c2, r2 = r1, c1
    y = ntt(y, field, inverse=True, scale=False, radix=4)
    y = _rank1_plain(y, field, pre_seed2, c2, r2)
    y = ntt(y, field, inverse=False, scale=False, radix=4)
    y = _twiddle_plain(y, field, c2 * r2, c2, False, False, _seed_tr(r2))
    return gf._ret(y.permute(1, 0, 2).contiguous(), u)


def row_pass_plain(y: torch.Tensor, field: FieldSpec, inverse: bool = False):
    """Plain pass B: R-point stages along axis 0 of [R, C, L]."""
    return ntt(y, field, inverse=inverse, scale=False, radix=4)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _cuda_input(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.uint32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous 3-D torch.uint32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if not 2 <= x.shape[0] <= MAX_PASS_LEN:
        raise ValueError(f"{name}: transform length {x.shape[0]} outside "
                         f"[2, {MAX_PASS_LEN}]")


def _dispatch(x: torch.Tensor, name: str) -> bool:
    """True to launch the kernel (CUDA tensor), False for the plain
    version (CPU tensor); raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _cuda_input(x, name)
    return True


def _field_code(field: FieldSpec) -> int:
    return 0 if field.use_mont else 1


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_col(x3, field, inverse, scale, pre_seed):
    c, r, lanes = x3.shape
    dev = str(x3.device)
    tr = _seed_tr(r)
    tw, w3 = _stage_tables_on(field.name, c, inverse, dev)
    seed, t0 = _seeds_on(field.name, c * r, c, inverse, scale, tr, dev)
    out = torch.empty((r, c, lanes), dtype=torch.uint32, device=x3.device)
    args = [_field_code(field), x3.data_ptr(), out.data_ptr(), c, r, lanes,
            tw.data_ptr(), w3.data_ptr(), seed.data_ptr(), t0.data_ptr(), tr]
    with torch.cuda.device(x3.device):
        if pre_seed is None:
            _build.call("fecc_col", *args, _stream(x3))
            LAUNCHES["K1_col"] += 1
        else:
            pcol, prow = _pre_on(field.name, pre_seed % field.p, c, r, tr,
                                 dev)
            _build.call("fecc_col_pre", *args, pcol.data_ptr(),
                        prow.data_ptr(), _stream(x3))
            LAUNCHES["K4_col_pre"] += 1
    return out


def col_pass(x3: torch.Tensor, field: FieldSpec, inverse: bool = False,
             scale: bool = True) -> torch.Tensor:
    """K1 (pass A): [C, R, L] u32 -> [R, C, L]."""
    if not _dispatch(x3, "col_pass"):
        return col_pass_plain(x3, field, inverse, scale)
    return _launch_col(x3, field, inverse, scale, None)


def col_pass_pre(x3: torch.Tensor, field: FieldSpec, pre_seed: int,
                 inverse: bool = False, scale: bool = True) -> torch.Tensor:
    """K4 (pass A with x[m] *= pre_seed^m, m = r + R*c): [C, R, L] ->
    [R, C, L]."""
    if not _dispatch(x3, "col_pass_pre"):
        return col_pass_plain(x3, field, inverse, scale, pre_seed)
    return _launch_col(x3, field, inverse, scale, pre_seed)


def seam_pass(y1: torch.Tensor, field: FieldSpec,
              pre_seed2: int) -> torch.Tensor:
    """K2 (the pair's middle pass): [R1, C1, L] u32 -> [C1, R1, L]."""
    if not _dispatch(y1, "seam_pass"):
        return seam_pass_plain(y1, field, pre_seed2)
    r1, c1, lanes = y1.shape
    c2, r2 = r1, c1
    dev = str(y1.device)
    tr = _seed_tr(r2)
    tw1, w31 = _stage_tables_on(field.name, r1, True, dev)
    tw2, w32 = _stage_tables_on(field.name, c2, False, dev)
    seed, t0 = _seeds_on(field.name, c2 * r2, c2, False, False, tr, dev)
    pcol, prow = _pre_on(field.name, pre_seed2 % field.p, c2, r2, tr, dev)
    out = torch.empty((r2, c2, lanes), dtype=torch.uint32, device=y1.device)
    with torch.cuda.device(y1.device):
        _build.call("fecc_seam", _field_code(field), y1.data_ptr(),
                    out.data_ptr(), r1, c1, lanes, tw1.data_ptr(),
                    w31.data_ptr(), tw2.data_ptr(), w32.data_ptr(),
                    seed.data_ptr(), t0.data_ptr(), tr, pcol.data_ptr(),
                    prow.data_ptr(), _stream(y1))
        LAUNCHES["K2_seam"] += 1
    return out


def row_pass(y: torch.Tensor, field: FieldSpec,
             inverse: bool = False) -> torch.Tensor:
    """K3 (pass B): [R, C, L] u32 -> [R, C, L], natural order."""
    if not _dispatch(y, "row_pass"):
        return row_pass_plain(y, field, inverse)
    r, c, lanes = y.shape
    tw, w3 = _stage_tables_on(field.name, r, inverse, str(y.device))
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        _build.call("fecc_row", _field_code(field), y.data_ptr(),
                    out.data_ptr(), r, c, lanes, tw.data_ptr(),
                    w3.data_ptr(), _stream(y))
        LAUNCHES["K3_row"] += 1
    return out


# ---------------------------------------------------------------------------
# Transforms.
# ---------------------------------------------------------------------------

def ntt_fused(x: torch.Tensor, field: FieldSpec, inverse: bool = False,
              scale: bool = True, pre_seed: int | None = None) -> torch.Tensor:
    """Two-pass NTT along axis 0 of u32 [N, L] (the counterpart of
    ``ntt_pallas``): pass A (K1, or K4 with ``pre_seed``), then pass B
    (K3). Bit-exact vs ``ntt.ntt``."""
    n, lanes = x.shape
    _check_order(x, n)
    c = _split(n)
    x3 = x.contiguous().reshape(c, n // c, lanes)
    if pre_seed is None:
        col = col_pass(x3, field, inverse, scale)
    else:
        col = col_pass_pre(x3, field, pre_seed, inverse, scale)
    return row_pass(col, field, inverse).reshape(n, lanes)


def ntt_coset_pair(x: torch.Tensor, field: FieldSpec,
                   pre_seed: int) -> torch.Tensor:
    """The RS-encode pair NTT_g-coset(iNTT(x)) along axis 0 of u32 [N, L],
    bit-exact vs ``ntt_auto(ntt_auto(x, inverse=True), pre_seed=g)``, in
    three passes: A1 (K1: inverse columns, N^-1 folded into the twiddle),
    the seam (K2) and B2 (K3). The counterpart of ``ntt_coset_pair_pallas``
    (``ntt_pair_pallas(pre_seed2=g)``) without its opt-in one-pass
    dispatch."""
    n, lanes = x.shape
    _check_order(x, n)
    c1 = _pair_split(n)
    col1 = col_pass(x.contiguous().reshape(c1, n // c1, lanes), field,
                    inverse=True, scale=True)
    col2 = seam_pass(col1, field, pre_seed)
    return row_pass(col2, field, inverse=False).reshape(n, lanes)
