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

The pair NTT(v2 * iNTT(v1 * x)) of both codec paths runs in three
passes: A1, the seam (K2: transform 1's pass B, the middle multiply,
transform 2's pass A in one residency) and B2. The seam needs transform 2
to take the swapped split (c2, r2) = (r1, c1): transform 1's pass-B
output column IS transform 2's pass-A input column. RS encode multiplies
in the middle by the coset powers g^m (rank-1 tables); erasure decode
fuses a general prepared [N] table into each pass instead (K5: the
locator evaluations before A1; K6: the x d/dx table m in the seam; K7:
the Forney inverse derivative after B2, and K7-sel also the erased-row
merge where(mask[k] != 0, out[k], orig[k])).

The GF16 wire pair (:func:`ntt_coset_pair_wire16`) is the encode pair
over [k, Wu] u32 pairs of little-endian u16 wire words: K8 splits each
pair into lo = x & 0xFFFF and hi = x >> 16 and runs K1 on both, K9 runs
K2's kernel on each, and K10 runs K3 on both and writes the wire parity directly:
stored = lo16 | hi16 << 16 (0x10000 stored as 0) and the escape bitmap.
Lo and hi are independent lane sets; between passes they are one
[2, ...] tensor, half 0 lo and half 1 hi.

The one-pass "lanes" pair (K11, :func:`ntt_pair_lanes`) runs the
encode pair with whole k-point columns resident: unscaled k-point
inverse transform, x g^m k^-1 (:func:`_pair_mid_table`), k-point forward
transform; K12 (:func:`ntt_pair_lanes_wire16`) is K11 on lo and hi with
K10's epilogue. As in the reference they are opt-in
(``FASTECC_LANES_PAIR``, read into :data:`LANES_PAIR_ENABLED`): with the
flag set, :func:`ntt_coset_pair` and :func:`ntt_coset_pair_wire16` take
them for k a power of two in [32, 2^13] (:func:`_pair_lanes_supported`,
the port's own gate) on every device; both routes give the same bits.

Each kernel has a wrapper and a plain PyTorch version here. The wrapper
takes the plain version only for a CPU tensor; on a CUDA tensor it
launches its Hopper kernel (``csrc/col.cu``: K1, K2, K4, K5, K6, K8,
K9; ``csrc/row.cu``: K3, K7, K7-sel, K10; ``csrc/lanes.cu``: K11, K12)
or raises, and
counts the launch in :data:`LAUNCHES`. Each wrapper's host work for its pass
(the tables, the output, the C call, or the plain version) runs inside the
span ``fecc.pass.<key>`` (:class:`_Pass`), key the pass's :data:`LAUNCHES`
key, which records while a torch profiler does.
Split, lane tile and twiddle tables are the port's own; the output bits
are the reference's.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import gf
from ..fields import FieldSpec, FIELDS
from ..ntt import (_log2, _r4_twiddles, _stage_twiddles, mul_prepared, ntt,
                   powers_host, powers_outer_host, prepare_consts)
from ..utils import profiling
from . import _build

# Smallest transform order the kernels take: both factors of the split
# must be at least 2.
MIN_ORDER = 4
# Largest transform length along a pass's axis 0. The largest order either
# field has is 2^20 (GF32's two-adic order), which the splits below make
# 1024 x 1024 (single) and 512 x 1024 (pair).
MAX_PASS_LEN = 1 << 10

# The C entry of each pass, by the pass's key.
_ENTRIES = {"K1_col": "fecc_col", "K2_seam": "fecc_seam",
            "K3_row": "fecc_row", "K4_col_pre": "fecc_col_pre",
            "K5_col_vec": "fecc_col_vec", "K6_seam_vec": "fecc_seam_vec",
            "K7_row_post": "fecc_row_post",
            "K7_row_post_sel": "fecc_row_post_sel",
            "K8_col_wire16": "fecc_col_wire16",
            "K9_seam_wire16": "fecc_seam_wire16",
            "K10_row_wire16": "fecc_row_wire16",
            "K11_pair_lanes": "fecc_pair_lanes",
            "K12_pair_lanes_wire16": "fecc_pair_lanes_wire16"}
# Launches per kernel, counted by the wrappers where they launch.
LAUNCHES = dict.fromkeys(_ENTRIES, 0)


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


def _row_split(a: int) -> tuple[int, int]:
    """The register split of an a-point column (K1-K3), (A1, A2): A1 =
    2^ceil(log2 a / 2) points in registers first, A2 = a / A1 after the
    exchange (32 x 16 at 512, 32 x 32 at 1024)."""
    t = _log2(a)
    return 1 << ((t + 1) // 2), 1 << (t // 2)


@functools.lru_cache(maxsize=None)
def _split_twiddles(field_name: str, a: int, a1: int, inverse: bool):
    """Prepared [a / a1, a1] table T[n2, k1] = w_a^(n2 * k1) (w^-1 for the
    inverse): the four-step twiddle between the a1-point and the
    (a / a1)-point halves of an a-point column. GF16 entries can be
    0x10000."""
    field = FIELDS[field_name]
    w = field.root_of_order(a)
    if inverse:
        w = field.inv_host(w)
    return np.asarray(prepare_consts(
        field, powers_outer_host(field, powers_host(field, w, a // a1), a1)))


def _row_inner_twiddles(field_name: str, a: int, inverse: bool):
    """The inner twiddles of K1-K3: the [A2, A1] table of
    :func:`_split_twiddles` at the register split :func:`_row_split`
    (``csrc/regstages.cuh``)."""
    return _split_twiddles(field_name, a, _row_split(a)[0], inverse)


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
def _pair_mid_table(field_name: str, k: int, g: int):
    """Prepared [k, 1] mid-pair table t[m] = prep(g^m * k^-1): the coset
    multiply with the iNTT's scale folded in (the lanes kernels run the
    inverse stages unscaled)."""
    field = FIELDS[field_name]
    t = powers_host(field, g % field.p, k).astype(np.uint64)
    t = t * np.uint64(field.inv_host(k)) % np.uint64(field.p)
    return np.asarray(prepare_consts(field, t.astype(np.uint32)))[:, None]


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
def _row_tw_on(field_name: str, a: int, inverse: bool, device: str):
    return _u32_on(_row_inner_twiddles(field_name, a, inverse), device)


@functools.lru_cache(maxsize=None)
def _seeds_on(field_name: str, n: int, c: int, inverse: bool, scale: bool,
              tr: int, device: str):
    seed, t0 = _colpass_seeds(field_name, n, c, inverse, scale, tr)
    return _u32_on(seed, device), _u32_on(t0, device)


@functools.lru_cache(maxsize=None)
def _pre_on(field_name: str, g: int, c: int, r: int, tr: int, device: str):
    pcol, prow = _pre_mul_tables(field_name, g, c, r, tr)
    return _u32_on(pcol, device), _u32_on(prow, device)


@functools.lru_cache(maxsize=None)
def _mid_on(field_name: str, k: int, g: int, device: str):
    return _u32_on(_pair_mid_table(field_name, k, g), device)


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


def _vec_plain(x, field: FieldSpec, vec):
    """x [A, B, L] *= vec[a * B + b], a prepared [A * B] table."""
    (v,), _ = gf._carried(vec)
    return mul_prepared(field, x, v.reshape(x.shape[0], x.shape[1], 1))


def col_pass_plain(x3: torch.Tensor, field: FieldSpec, inverse: bool = False,
                   scale: bool = True, pre_seed: int | None = None,
                   pre_vec=None):
    """Plain pass A: [C, R, L] -> [R, C, L], optionally after the rank-1
    x[m] *= pre_seed^m or the general x[m] *= pre_vec[m] (m = c*R + r)."""
    (x,), u = gf._carried(x3)
    c, r, _ = x.shape
    if pre_seed is not None:
        x = _rank1_plain(x, field, pre_seed, c, r)
    if pre_vec is not None:
        x = _vec_plain(x, field, pre_vec)
    y = ntt(x, field, inverse=inverse, scale=False, radix=4)
    y = _twiddle_plain(y, field, c * r, c, inverse, scale, _seed_tr(r))
    return gf._ret(y.permute(1, 0, 2).contiguous(), u)


def seam_pass_plain(y1: torch.Tensor, field: FieldSpec,
                    pre_seed2: int | None = None, pre_vec2=None):
    """Plain seam: [R1, C1, L] -> [C1, R1, L]: inverse R1-point stages,
    x g^m (``pre_seed2``) or x v[m] (``pre_vec2``), m = c2*R2 + r2,
    forward stages (C2 = R1), x T2, transpose."""
    (y,), u = gf._carried(y1)
    r1, c1, _ = y.shape
    c2, r2 = r1, c1
    y = ntt(y, field, inverse=True, scale=False, radix=4)
    if pre_vec2 is None:
        y = _rank1_plain(y, field, pre_seed2, c2, r2)
    else:
        y = _vec_plain(y, field, pre_vec2)
    y = ntt(y, field, inverse=False, scale=False, radix=4)
    y = _twiddle_plain(y, field, c2 * r2, c2, False, False, _seed_tr(r2))
    return gf._ret(y.permute(1, 0, 2).contiguous(), u)


def row_pass_plain(y: torch.Tensor, field: FieldSpec, inverse: bool = False,
                   post_vec=None, sel_mask=None, sel_orig=None):
    """Plain pass B: R-point stages along axis 0 of [R, C, L], then
    optionally out[k] *= post_vec[k] and the row select
    where(sel_mask[k] != 0, out[k], sel_orig[k]) (k = k_r*C + k_c)."""
    out = ntt(y, field, inverse=inverse, scale=False, radix=4)
    if post_vec is None:
        return out
    (o,), u = gf._carried(out)
    o = _vec_plain(o, field, post_vec)
    if sel_mask is not None:
        (mask, orig), _ = gf._carried(sel_mask, sel_orig)
        keep = mask.reshape(o.shape[0], o.shape[1], 1) != 0
        o = torch.where(keep, o, orig.reshape(o.shape))
    return gf._ret(o, u)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _cuda_input(x: torch.Tensor, name: str, dims: int = 3) -> None:
    """A pass input: contiguous u32 of ``dims`` axes, transform along
    axis -3 (K9 takes [2, A, B, L])."""
    if x.dtype != torch.uint32 or x.dim() != dims or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {dims}-D torch.uint32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if not 2 <= x.shape[-3] <= MAX_PASS_LEN:
        raise ValueError(f"{name}: transform length {x.shape[-3]} outside "
                         f"[2, {MAX_PASS_LEN}]")


def _dispatch(x: torch.Tensor, name: str, dims: int = 3) -> bool:
    """True to launch the kernel (CUDA tensor), False for the plain
    version (CPU tensor); raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _cuda_input(x, name, dims)
    return True


def _cuda_operand(t: torch.Tensor, x: torch.Tensor, numel: int,
                  name: str) -> int:
    """Pointer of a table (or ``orig``) operand of a pass over ``x``:
    u32, on x's device, contiguous, ``numel`` elements."""
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.uint32
            or t.device != x.device or not t.is_contiguous()
            or t.numel() != numel):
        raise ValueError(
            f"{name}: needs a contiguous torch.uint32 operand of {numel} "
            f"elements on {x.device}, got "
            f"{getattr(t, 'dtype', type(t))} "
            f"{tuple(getattr(t, 'shape', ()))} "
            f"on {getattr(t, 'device', None)}")
    return t.data_ptr()


def _check_sel(post_vec, sel_mask, sel_orig) -> None:
    if (sel_mask is None) != (sel_orig is None):
        raise ValueError("sel_mask and sel_orig go together")
    if sel_mask is not None and post_vec is None:
        raise ValueError("the fused select requires post_vec")


def _field_code(field: FieldSpec) -> int:
    return 0 if field.use_mont else 1


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


class _Pass:
    """One pass of a wrapper: its host work inside the span
    ``fecc.pass.<key>`` (``with _Pass(key) as p:``), and :meth:`launch`,
    which calls the key's C entry and counts it in :data:`LAUNCHES` under
    the same key."""

    __slots__ = ("key", "_span")

    def __init__(self, key: str):
        self.key = key
        self._span = profiling.scope("fecc.pass." + key)

    def __enter__(self) -> "_Pass":
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        return self._span.__exit__(*exc)

    def launch(self, *args) -> None:
        _build.call(_ENTRIES[self.key], *args)
        LAUNCHES[self.key] += 1


def _launch_col(p, x3, field, inverse, scale, pre_seed=None, pre_vec=None):
    c, r, lanes = x3.shape
    dev = str(x3.device)
    tr = _seed_tr(r)
    seed, t0 = _seeds_on(field.name, c * r, c, inverse, scale, tr, dev)
    out = torch.empty((r, c, lanes), dtype=torch.uint32, device=x3.device)
    tw = _row_tw_on(field.name, c, inverse, dev)
    args = [_field_code(field), x3.data_ptr(), out.data_ptr(), c, r, lanes,
            int(inverse), tw.data_ptr(), seed.data_ptr(), t0.data_ptr(), tr]
    with torch.cuda.device(x3.device):
        if pre_vec is not None:
            vec = _cuda_operand(pre_vec, x3, c * r, "col_pass_vec: pre_vec")
            p.launch(*args, vec, _stream(x3))
        elif pre_seed is not None:
            pcol, prow = _pre_on(field.name, pre_seed % field.p, c, r, tr,
                                 dev)
            p.launch(*args, pcol.data_ptr(), prow.data_ptr(), _stream(x3))
        else:
            p.launch(*args, _stream(x3))
    return out


def col_pass(x3: torch.Tensor, field: FieldSpec, inverse: bool = False,
             scale: bool = True) -> torch.Tensor:
    """K1 (pass A): [C, R, L] u32 -> [R, C, L] (``csrc/col.cu``: the
    register-stage kernel, its length a template parameter)."""
    with _Pass("K1_col") as p:
        if not _dispatch(x3, "col_pass"):
            return col_pass_plain(x3, field, inverse, scale)
        return _launch_col(p, x3, field, inverse, scale)


def col_pass_pre(x3: torch.Tensor, field: FieldSpec, pre_seed: int,
                 inverse: bool = False, scale: bool = True) -> torch.Tensor:
    """K4 (pass A with x[m] *= pre_seed^m, m = r + R*c): [C, R, L] ->
    [R, C, L] (``csrc/col.cu``: K1's kernel with the rank-1 row
    pcol[c] * prow[r] applied as the tile enters the registers)."""
    with _Pass("K4_col_pre") as p:
        if not _dispatch(x3, "col_pass_pre"):
            return col_pass_plain(x3, field, inverse, scale, pre_seed)
        return _launch_col(p, x3, field, inverse, scale, pre_seed=pre_seed)


def col_pass_vec(x3: torch.Tensor, field: FieldSpec, pre_vec: torch.Tensor,
                 inverse: bool = False, scale: bool = True) -> torch.Tensor:
    """K5 (pass A with x[m] *= pre_vec[m], m = c*R + r, a prepared [N]
    u32 table): [C, R, L] -> [R, C, L] (``csrc/col.cu``: K1's kernel with
    the table's column copied in beside the tile and applied as the tile
    enters the registers)."""
    with _Pass("K5_col_vec") as p:
        if not _dispatch(x3, "col_pass_vec"):
            return col_pass_plain(x3, field, inverse, scale, pre_vec=pre_vec)
        return _launch_col(p, x3, field, inverse, scale, pre_vec=pre_vec)


def _launch_seam(p, y1, field, pre_seed2=None, pre_vec2=None):
    r1, c1, lanes = y1.shape
    c2, r2 = r1, c1
    dev = str(y1.device)
    tr = _seed_tr(r2)
    seed, t0 = _seeds_on(field.name, c2 * r2, c2, False, False, tr, dev)
    out = torch.empty((r2, c2, lanes), dtype=torch.uint32, device=y1.device)
    head = [_field_code(field), y1.data_ptr(), out.data_ptr(), r1, c1, lanes]
    tw_inv = _row_tw_on(field.name, r1, True, dev)
    tw_fwd = _row_tw_on(field.name, c2, False, dev)
    tables = [tw_inv.data_ptr(), tw_fwd.data_ptr(), seed.data_ptr(),
              t0.data_ptr(), tr]
    with torch.cuda.device(y1.device):
        if pre_vec2 is None:
            pcol, prow = _pre_on(field.name, pre_seed2 % field.p, c2, r2, tr,
                                 dev)
            p.launch(*head, *tables, pcol.data_ptr(), prow.data_ptr(),
                     _stream(y1))
        else:
            vec = _cuda_operand(pre_vec2, y1, c2 * r2,
                                "seam_pass_vec: pre_vec2")
            p.launch(*head, *tables, vec, _stream(y1))
    return out


def seam_pass(y1: torch.Tensor, field: FieldSpec,
              pre_seed2: int) -> torch.Tensor:
    """K2 (the encode pair's middle pass, g^m in the middle): [R1, C1, L]
    u32 -> [C1, R1, L] (``csrc/col.cu``, both transforms in registers)."""
    with _Pass("K2_seam") as p:
        if not _dispatch(y1, "seam_pass"):
            return seam_pass_plain(y1, field, pre_seed2)
        return _launch_seam(p, y1, field, pre_seed2=pre_seed2)


def seam_pass_vec(y1: torch.Tensor, field: FieldSpec,
                  pre_vec2: torch.Tensor) -> torch.Tensor:
    """K6 (the decode pair's middle pass, a prepared [N] u32 table v[m]
    in the middle, m = c2*R2 + r2): [R1, C1, L] -> [C1, R1, L]
    (``csrc/col.cu``: K2's kernel with the middle row from the table)."""
    with _Pass("K6_seam_vec") as p:
        if not _dispatch(y1, "seam_pass_vec"):
            return seam_pass_plain(y1, field, pre_vec2=pre_vec2)
        return _launch_seam(p, y1, field, pre_vec2=pre_vec2)


def row_pass(y: torch.Tensor, field: FieldSpec,
             inverse: bool = False) -> torch.Tensor:
    """K3 (pass B): [R, C, L] u32 -> [R, C, L], natural order
    (``csrc/row.cu``: the register-stage kernel, its length a template
    parameter)."""
    with _Pass("K3_row") as p:
        if not _dispatch(y, "row_pass"):
            return row_pass_plain(y, field, inverse)
        r, c, lanes = y.shape
        tw = _row_tw_on(field.name, r, inverse, str(y.device))
        out = torch.empty_like(y)
        with torch.cuda.device(y.device):
            p.launch(_field_code(field), y.data_ptr(), out.data_ptr(), r, c,
                     lanes, int(inverse), tw.data_ptr(), _stream(y))
        return out


def row_pass_post(y: torch.Tensor, field: FieldSpec, post_vec: torch.Tensor,
                  sel_mask: torch.Tensor | None = None,
                  sel_orig: torch.Tensor | None = None,
                  inverse: bool = False) -> torch.Tensor:
    """K7 (pass B, then out[k] *= post_vec[k], k = k_r*C + k_c) or, with
    ``sel_mask``/``sel_orig`` ([N] u32 and [R, C, L] u32), K7-sel (then
    out[k] where sel_mask[k] != 0, else sel_orig[k]): [R, C, L] u32 ->
    [R, C, L], natural order (``csrc/row.cu``: K3's schedule with the
    table multiply, or the select, in its store)."""
    _check_sel(post_vec, sel_mask, sel_orig)
    with _Pass("K7_row_post" if sel_mask is None
               else "K7_row_post_sel") as p:
        if not _dispatch(y, "row_pass_post"):
            return row_pass_plain(y, field, inverse, post_vec, sel_mask,
                                  sel_orig)
        r, c, lanes = y.shape
        vec = _cuda_operand(post_vec, y, r * c, "row_pass_post: post_vec")
        out = torch.empty_like(y)
        tw = _row_tw_on(field.name, r, inverse, str(y.device))
        head = [_field_code(field), y.data_ptr(), out.data_ptr(), r, c, lanes,
                int(inverse), tw.data_ptr(), vec]
        with torch.cuda.device(y.device):
            if sel_mask is None:
                p.launch(*head, _stream(y))
            else:
                mask = _cuda_operand(sel_mask, y, r * c,
                                     "row_pass_post: sel_mask")
                orig = _cuda_operand(sel_orig, y, y.numel(),
                                     "row_pass_post: sel_orig")
                p.launch(*head, mask, orig, _stream(y))
        return out


# ---------------------------------------------------------------------------
# Transforms.
# ---------------------------------------------------------------------------

def _pass_b(col, field, inverse, post_vec, sel_mask, sel_orig):
    """Pass B of a transform: K3, or K7 / K7-sel with the output fusions
    (``sel_orig`` is the [N, L] original, viewed like ``col``)."""
    if post_vec is None:
        return row_pass(col, field, inverse)
    if sel_orig is not None:
        sel_orig = sel_orig.contiguous().reshape(col.shape)
    return row_pass_post(col, field, post_vec, sel_mask, sel_orig, inverse)


def ntt_fused(x: torch.Tensor, field: FieldSpec, inverse: bool = False,
              scale: bool = True, pre_seed: int | None = None,
              pre_vec: torch.Tensor | None = None,
              post_vec: torch.Tensor | None = None,
              sel_mask: torch.Tensor | None = None,
              sel_orig: torch.Tensor | None = None) -> torch.Tensor:
    """Two-pass NTT along axis 0 of u32 [N, L] (the counterpart of
    ``ntt_pallas``), bit-exact vs ``ntt.ntt``. Pass A is K1, K4 with
    ``pre_seed`` (x[m] *= g^m) or K5 with ``pre_vec`` (x[m] *= v[m]); pass
    B is K3, K7 with ``post_vec`` (out[k] *= v[k]) or K7-sel with
    ``post_vec`` and ``sel_mask``/``sel_orig`` (out[k] where mask[k] != 0,
    else orig[k]). Tables are prepared [N] u32 tensors on x's device;
    ``sel_orig`` is [N, L] u32."""
    if pre_seed is not None and pre_vec is not None:
        raise ValueError("pre_seed and pre_vec are mutually exclusive")
    _check_sel(post_vec, sel_mask, sel_orig)
    n, lanes = x.shape
    _check_order(x, n)
    c = _split(n)
    x3 = x.contiguous().reshape(c, n // c, lanes)
    if pre_vec is not None:
        col = col_pass_vec(x3, field, pre_vec, inverse, scale)
    elif pre_seed is not None:
        col = col_pass_pre(x3, field, pre_seed, inverse, scale)
    else:
        col = col_pass(x3, field, inverse, scale)
    return _pass_b(col, field, inverse, post_vec, sel_mask,
                   sel_orig).reshape(n, lanes)


def ntt_pair(x: torch.Tensor, field: FieldSpec, pre_seed2: int | None = None,
             pre_vec1: torch.Tensor | None = None,
             pre_vec2: torch.Tensor | None = None,
             post_vec: torch.Tensor | None = None,
             sel_mask: torch.Tensor | None = None,
             sel_orig: torch.Tensor | None = None) -> torch.Tensor:
    """NTT(v2 * iNTT(v1 * x)) along axis 0 of u32 [N, L], the
    two-transform shape of both codec paths (the counterpart of
    ``ntt_pair_pallas``), in three passes: A1 (inverse columns, N^-1
    folded into the twiddle; K1, or K5 with ``pre_vec1``), the seam (K2
    with the coset powers ``pre_seed2=g``, or K6 with the table
    ``pre_vec2``: exactly one of the two) and B2 (K3, or K7 / K7-sel with
    ``post_vec`` and ``sel_mask``/``sel_orig``, as in :func:`ntt_fused`).
    Bit-exact vs the two staged transforms."""
    if (pre_seed2 is None) == (pre_vec2 is None):
        raise ValueError("exactly one of pre_seed2/pre_vec2 (a pair with "
                         "no middle multiply is the identity)")
    _check_sel(post_vec, sel_mask, sel_orig)
    n, lanes = x.shape
    _check_order(x, n)
    c1 = _pair_split(n)
    x3 = x.contiguous().reshape(c1, n // c1, lanes)
    if pre_vec1 is None:
        col1 = col_pass(x3, field, inverse=True, scale=True)
    else:
        col1 = col_pass_vec(x3, field, pre_vec1, inverse=True, scale=True)
    if pre_vec2 is None:
        col2 = seam_pass(col1, field, pre_seed2)
    else:
        col2 = seam_pass_vec(col1, field, pre_vec2)
    return _pass_b(col2, field, False, post_vec, sel_mask,
                   sel_orig).reshape(n, lanes)


def ntt_coset_pair(x: torch.Tensor, field: FieldSpec,
                   pre_seed: int) -> torch.Tensor:
    """The RS-encode pair NTT_g-coset(iNTT(x)) over u32 [k, L]: the
    one-pass K11 (:func:`ntt_pair_lanes`) where the lanes pair is switched
    on and takes k (:func:`_pair_lanes_supported`), else :func:`ntt_pair`
    with the coset powers g^m in the middle (K1 -> K2 -> K3)."""
    if _pair_lanes_supported(*x.shape):
        return ntt_pair_lanes(x, field, pre_seed)
    return ntt_pair(x, field, pre_seed2=pre_seed)


# The pair switch, as in the reference: with FASTECC_NO_SEAM set (or below
# the kernels' smallest order), the callers (rs.encode_parity,
# rs.encode_blocks, decode.decode_prepared and
# decode.decode_data_from_parity) run two staged transforms in place of a
# pair: K1 -> K3 then K4 -> K3 for the encode, K5 -> K3 then K5 -> K7-sel
# for the decode. Both routes give the same bits; the CLI's ``--seam off``
# turns it off for one command.
PAIR_ENABLED = not os.environ.get("FASTECC_NO_SEAM")


def _pair_supported(n: int) -> bool:
    """The callers' gate for the three-pass pair over order ``n``: the
    switch, and an order the kernels split (the reference's tile
    conditions are TPU tile facts)."""
    return PAIR_ENABLED and n >= MIN_ORDER


# ---------------------------------------------------------------------------
# The one-pass "lanes" pair (K11, K12).
# ---------------------------------------------------------------------------

# Opt-in, as in the reference: set FASTECC_LANES_PAIR to route the encode
# pair through the lanes kernels.
LANES_PAIR_ENABLED = bool(os.environ.get("FASTECC_LANES_PAIR"))
# The gate's orders: the reference's lower bound, and the order its wire
# bench built K12 for. At 2^13 a block's [k, 4] tile and exchange take
# 132 KiB of shared memory (``csrc/lanes.cu``'s two-exchange split).
MIN_LANES_K = 32
MAX_LANES_K = 1 << 13


def _pair_lanes_supported(k: int, lanes: int) -> bool:
    """The port's gate for the lanes pair over [k, lanes]: switched on,
    and k a power of two in [32, 2^13]. (The reference's tile conditions
    are TPU tile facts; the wire form's Wu % 8 == 0 is the wire gate's.)"""
    return (LANES_PAIR_ENABLED and MIN_LANES_K <= k <= MAX_LANES_K
            and k & (k - 1) == 0 and lanes > 0)


def pair_lanes_plain(x: torch.Tensor, field: FieldSpec,
                     pre_seed: int) -> torch.Tensor:
    """Plain K11: NTT(mid * iNTT_unscaled(x)) along axis 0 of [k, L],
    mid = g^m k^-1 (bit-exact vs the three-pass coset pair)."""
    (y,), u = gf._carried(x)
    k = y.shape[0]
    y = ntt(y, field, inverse=True, scale=False, radix=4)
    mid = gf.table(_pair_mid_table(field.name, k, pre_seed % field.p),
                   y.device)
    return gf._ret(ntt(mul_prepared(field, y, mid), field, radix=4), u)


def pair_lanes_wire16_plain(x_pairs: torch.Tensor, field: FieldSpec,
                            pre_seed: int):
    """Plain K12: [k, Wu] u32 pairs -> (stored [k, Wu], bitmap [k, Wu/8]):
    plain K11 on lo = x & 0xFFFF and hi = x >> 16, then K10's epilogue
    (:func:`_wire16_parts`)."""
    (x,), u = gf._carried(x_pairs)
    stored, bitmap = _wire16_parts(pair_lanes_plain(x & 0xFFFF, field,
                                                    pre_seed),
                                   pair_lanes_plain(x >> 16, field, pre_seed))
    return gf._ret(stored, u), gf._ret(bitmap, u)


def _lanes_input(x: torch.Tensor, name: str) -> None:
    """A lanes-kernel input on the card: contiguous 2-D u32 [k, L], k a
    power of two in [4, 2^13]."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.uint32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous 2-D torch.uint32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    k = x.shape[0]
    if not (MIN_ORDER <= k <= MAX_LANES_K and k & (k - 1) == 0):
        raise ValueError(f"{name}: needs k a power of two in [{MIN_ORDER}, "
                         f"{MAX_LANES_K}], got {k}")


# The lanes kernels' split of a k-point column (``csrc/lanes.cu``
# kTwoExchangeLogK11, kTwoExchangeLog): the engine's one-exchange split
# (RegSplit) below K11_TWO_EXCHANGE_K (K11) or K12_TWO_EXCHANGE_K (K12);
# from there on k = B1 * A1 * A2 with two exchanges and no thread holding
# more than 32 elements of a column.
K11_TWO_EXCHANGE_K = 1 << 11
K12_TWO_EXCHANGE_K = 1 << 12


def _lanes_b1(k: int) -> int:
    """B1 of the lanes kernels' two-exchange split k = B1 * M, M = A1 * A2
    with A1 = B1 = 2^ceil(log2 k / 3) (2^13 = 32 * 32 * 8, 2^12 = 16 * 16
    * 16, 2^11 = 16 * 16 * 8)."""
    return 1 << -(-_log2(k) // 3)


@functools.lru_cache(maxsize=None)
def _lanes_level_twiddles(field_name: str, k: int, inverse: bool):
    """The lanes kernels' twiddles between the outer B1-point level and
    the inner M-point transforms of the two-exchange split: inverse
    [B1, M] T[k1, n] = w_k^-(n * k1) (k1-major, as the inverse's first
    level reads them), forward [M, B1] T[kk, r] = w_k^(kk * r); prepared,
    GF16 entries can be 0x10000."""
    t = _split_twiddles(field_name, k, _lanes_b1(k), inverse)
    return np.ascontiguousarray(t.T) if inverse else t


@functools.lru_cache(maxsize=None)
def _lanes_tables_on(field_name: str, k: int, g: int, two_k: int,
                     device: str):
    """K11's or K12's tables on ``device`` for the split that takes two
    exchanges from ``two_k`` on: the level twiddles inverse and forward
    (None for the one-exchange split), the [A2, A1] inner twiddles of the
    (inner) register split inverse and forward, the mid table."""
    b1 = _lanes_b1(k) if k >= two_k else 0
    a, a1 = (k // b1, b1) if b1 else (k, _row_split(k)[0])
    lvl = [_u32_on(_lanes_level_twiddles(field_name, k, inv), device)
           if b1 else None for inv in (True, False)]
    inner = [_u32_on(_split_twiddles(field_name, a, a1, inv), device)
             for inv in (True, False)]
    return (*lvl, *inner, _mid_on(field_name, k, g, device))


def ntt_pair_lanes(x: torch.Tensor, field: FieldSpec,
                   pre_seed: int) -> torch.Tensor:
    """K11 (the counterpart of ``ntt_pair_lanes_pallas``): the encode pair
    NTT_g-coset(iNTT(x)) over u32 [k, L] in one pass, each block holding
    whole k-point columns; k a power of two in [4, 2^13]
    (``csrc/lanes.cu``: the register-stage kernel, its length and field
    template parameters, one block per lane tile)."""
    with _Pass("K11_pair_lanes") as p:
        if x.device.type == "cpu":
            return pair_lanes_plain(x, field, pre_seed)
        _lanes_input(x, "ntt_pair_lanes")
        k, lanes = x.shape
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            tables = _lanes_tables_on(field.name, k, pre_seed % field.p,
                                      K11_TWO_EXCHANGE_K, str(x.device))
            p.launch(_field_code(field), x.data_ptr(), out.data_ptr(), k,
                     lanes, *(None if t is None else t.data_ptr()
                              for t in tables), _stream(x))
        return out


# ---------------------------------------------------------------------------
# The GF16 wire pair (K8 -> K9 -> K10).
# ---------------------------------------------------------------------------

# GF16's largest rate-1/2 order: p - 1 = 2^16 is its two-adic order, and
# the pair's coset seed is a root of order 2k.
MAX_WIRE16_K = 1 << 15


def _wire16_supported(k: int, wu: int) -> bool:
    """The port's gate for the fused GF16 wire pair over [k, Wu] u32
    pairs: k a power of two in [4, 2^15] and whole bitmap groups of 8
    lanes. (The reference's tile conditions are TPU tile facts.)"""
    return (MIN_ORDER <= k <= MAX_WIRE16_K and k & (k - 1) == 0
            and wu > 0 and wu % 8 == 0)


def _check_gf16(field: FieldSpec, name: str) -> None:
    if field.use_mont:
        raise ValueError(f"{name}: the wire pair is the GF16 path")


def col_pass_wire16_plain(x3: torch.Tensor, field: FieldSpec) -> torch.Tensor:
    """Plain K8: [C1, R1, Wu] u32 pairs of LE u16 words -> [2, R1, C1, Wu]:
    the encode pair's pass A1 (inverse, N^-1 folded in) on lo = x & 0xFFFF
    (half 0) and on hi = x >> 16 (half 1)."""
    (x,), u = gf._carried(x3)
    halves = [col_pass_plain(h, field, inverse=True, scale=True)
              for h in (x & 0xFFFF, x >> 16)]
    return gf._ret(torch.stack(halves), u)


def seam_pass_wire16_plain(y: torch.Tensor, field: FieldSpec,
                           pre_seed2: int) -> torch.Tensor:
    """Plain K9: [2, R1, C1, Wu] -> [2, C1, R1, Wu], K2 on each half."""
    (y,), u = gf._carried(y)
    return gf._ret(torch.stack([seam_pass_plain(h, field, pre_seed2)
                                for h in y]), u)


def _wire16_parts(lo, hi):
    """(stored [k, Wu], bitmap [k, Wu/8]) carriers from the [k, Wu] lo and
    hi transform outputs: stored = lo16 | hi16 << 16 (0x10000 stored as
    0); bitmap word g of a row holds bit 2t (lo) and 2t+1 (hi) for lane
    8g + t where the value is 0x10000."""
    k, wu = lo.shape
    stored = (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)
    esc = ((lo >> 16) | ((hi >> 16) << 1)).reshape(k, wu // 8, 8)
    shifts = 2 * torch.arange(8, dtype=torch.int64, device=lo.device)
    return stored, (esc << shifts).sum(dim=-1)


def row_pass_wire16_plain(lo2: torch.Tensor, hi2: torch.Tensor,
                          field: FieldSpec):
    """Plain K10: lo, hi [R2, C2, Wu] -> (stored [k, Wu], bitmap
    [k, Wu/8]), k = R2*C2 in natural order (see :func:`_wire16_parts`)."""
    (lo, hi), u = gf._carried(lo2, hi2)
    r2, c2, wu = lo.shape
    stored, bitmap = _wire16_parts(
        row_pass_plain(lo, field).reshape(r2 * c2, wu),
        row_pass_plain(hi, field).reshape(r2 * c2, wu))
    return gf._ret(stored, u), gf._ret(bitmap, u)


def col_pass_wire16(x3: torch.Tensor, field: FieldSpec) -> torch.Tensor:
    """K8 (the wire pair's pass A1): [C1, R1, Wu] u32 pairs -> [2, R1, C1,
    Wu], lo in half 0 and hi in half 1 (``csrc/col.cu``: K1's GF16 kernel
    on both halves in one block, split as step 1 reads the tile)."""
    _check_gf16(field, "col_pass_wire16")
    with _Pass("K8_col_wire16") as p:
        if not _dispatch(x3, "col_pass_wire16"):
            return col_pass_wire16_plain(x3, field)
        c, r, lanes = x3.shape
        dev = str(x3.device)
        tr = _seed_tr(r)
        tw = _row_tw_on(field.name, c, True, dev)
        seed, t0 = _seeds_on(field.name, c * r, c, True, True, tr, dev)
        out = torch.empty((2, r, c, lanes), dtype=torch.uint32,
                          device=x3.device)
        with torch.cuda.device(x3.device):
            p.launch(_field_code(field), x3.data_ptr(), out.data_ptr(), c, r,
                     lanes, tw.data_ptr(), seed.data_ptr(), t0.data_ptr(), tr,
                     _stream(x3))
        return out


def seam_pass_wire16(y: torch.Tensor, field: FieldSpec,
                     pre_seed2: int) -> torch.Tensor:
    """K9 (the wire pair's middle pass, g^m in the middle): [2, R1, C1,
    Wu] u32 -> [2, C1, R1, Wu] (``csrc/col.cu``: K2's kernel, launched
    once on each half, with K2's tables)."""
    _check_gf16(field, "seam_pass_wire16")
    with _Pass("K9_seam_wire16") as p:
        if not _dispatch(y, "seam_pass_wire16", dims=4):
            return seam_pass_wire16_plain(y, field, pre_seed2)
        if y.shape[0] != 2:
            raise ValueError(f"seam_pass_wire16: needs [2, R1, C1, Wu] "
                             f"halves, got {tuple(y.shape)}")
        _, r1, c1, lanes = y.shape
        c2, r2 = r1, c1
        dev = str(y.device)
        tr = _seed_tr(r2)
        seed, t0 = _seeds_on(field.name, c2 * r2, c2, False, False, tr, dev)
        pcol, prow = _pre_on(field.name, pre_seed2 % field.p, c2, r2, tr, dev)
        tw_inv = _row_tw_on(field.name, r1, True, dev)
        tw_fwd = _row_tw_on(field.name, c2, False, dev)
        out = torch.empty((2, r2, c2, lanes), dtype=torch.uint32,
                          device=y.device)
        with torch.cuda.device(y.device):
            p.launch(_field_code(field), y.data_ptr(), out.data_ptr(), r1, c1,
                     lanes, tw_inv.data_ptr(), tw_fwd.data_ptr(),
                     seed.data_ptr(), t0.data_ptr(), tr, pcol.data_ptr(),
                     prow.data_ptr(), _stream(y))
        return out


def wire16_pass_b2(lo2: torch.Tensor, hi2: torch.Tensor, field: FieldSpec):
    """K10 (the wire pair's pass B2, callable on its own): lo, hi
    [R2, C2, Wu] u32 -> (stored [k, Wu], bitmap [k, Wu/8]) u32, the wire
    parity's two parts (see :func:`row_pass_wire16_plain`); Wu % 8 == 0
    (``csrc/row.cu``: K3's GF16 schedule on both halves in one block, the
    stored words from the registers, the escape bits OR-ed into the
    bitmap the entry zeroes)."""
    _check_gf16(field, "wire16_pass_b2")
    if lo2.dim() != 3 or hi2.shape != lo2.shape or lo2.shape[2] % 8:
        raise ValueError(f"wire16_pass_b2: needs lo and hi of one [R2, C2, "
                         f"Wu] shape with Wu % 8 == 0, got "
                         f"{tuple(lo2.shape)} and {tuple(hi2.shape)}")
    with _Pass("K10_row_wire16") as p:
        if not _dispatch(lo2, "wire16_pass_b2"):
            return row_pass_wire16_plain(lo2, hi2, field)
        r, c, lanes = lo2.shape
        hi = _cuda_operand(hi2, lo2, lo2.numel(), "wire16_pass_b2: hi2")
        tw = _row_tw_on(field.name, r, False, str(lo2.device))
        stored = torch.empty((r * c, lanes), dtype=torch.uint32,
                             device=lo2.device)
        bitmap = torch.empty((r * c, lanes // 8), dtype=torch.uint32,
                             device=lo2.device)
        with torch.cuda.device(lo2.device):
            p.launch(_field_code(field), lo2.data_ptr(), hi, stored.data_ptr(),
                     bitmap.data_ptr(), r, c, lanes, tw.data_ptr(),
                     _stream(lo2))
        return stored, bitmap


def ntt_coset_pair_wire16(x_pairs: torch.Tensor, field: FieldSpec,
                          pre_seed: int):
    """The GF16 wire-domain RS-encode pair (the counterpart of
    ``ntt_coset_pair_wire16_pallas``): [k, Wu] u32 pairs of LE u16 wire
    words in, (stored [k, Wu], bitmap [k, Wu/8]) u32 out, in three passes
    K8 -> K9 -> K10 on the port's pair split, or in one (K12) where the
    lanes pair is switched on and takes k. Bit-exact equal to
    serialize_parity(encode_parity(pack_data(...))) split at the
    stored/bitmap boundary. GF16 only (each pass checks)."""
    k, wu = x_pairs.shape
    if not _wire16_supported(k, wu):
        raise ValueError(f"ntt_coset_pair_wire16: needs k a power of two in "
                         f"[{MIN_ORDER}, {MAX_WIRE16_K}] and Wu % 8 == 0, "
                         f"got k={k} Wu={wu}")
    if _pair_lanes_supported(k, wu):
        return ntt_pair_lanes_wire16(x_pairs, field, pre_seed)
    c1 = _pair_split(k)
    halves = col_pass_wire16(x_pairs.contiguous().reshape(c1, k // c1, wu),
                             field)
    halves = seam_pass_wire16(halves, field, pre_seed)
    return wire16_pass_b2(halves[0], halves[1], field)


def ntt_pair_lanes_wire16(x_pairs: torch.Tensor, field: FieldSpec,
                          pre_seed: int):
    """K12 (the counterpart of ``ntt_pair_lanes_wire16_pallas``): the GF16
    wire pair in one pass, [k, Wu] u32 pairs of LE u16 wire words ->
    (stored [k, Wu], bitmap [k, Wu/8]) u32, the same parts as
    :func:`wire16_pass_b2`; k a power of two in [4, 2^13], Wu % 8 == 0
    (``csrc/lanes.cu``: the register-stage kernel, its length a template
    parameter, one block per lane tile and half)."""
    _check_gf16(field, "ntt_pair_lanes_wire16")
    if x_pairs.dim() != 2 or x_pairs.shape[1] % 8:
        raise ValueError(f"ntt_pair_lanes_wire16: needs [k, Wu] pairs with "
                         f"Wu % 8 == 0, got {tuple(x_pairs.shape)}")
    with _Pass("K12_pair_lanes_wire16") as p:
        if x_pairs.device.type == "cpu":
            return pair_lanes_wire16_plain(x_pairs, field, pre_seed)
        _lanes_input(x_pairs, "ntt_pair_lanes_wire16")
        k, wu = x_pairs.shape
        stored = torch.empty_like(x_pairs)
        bitmap = torch.empty((k, wu // 8), dtype=torch.uint32,
                             device=x_pairs.device)
        with torch.cuda.device(x_pairs.device):
            tables = _lanes_tables_on(field.name, k, pre_seed % field.p,
                                      K12_TWO_EXCHANGE_K, str(x_pairs.device))
            p.launch(_field_code(field), x_pairs.data_ptr(),
                     stored.data_ptr(), bitmap.data_ptr(), k, wu,
                     *(None if t is None else t.data_ptr() for t in tables),
                     _stream(x_pairs))
        return stored, bitmap
