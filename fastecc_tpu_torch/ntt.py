"""Number-theoretic transforms over GF(p): the port's counterpart of
``ntt.py``.

Host tables (numpy, copied from the reference so both packages build the
same prepared constants) and the plain PyTorch transforms:

  * ``ntt``/``intt``: Stockham autosort DIF at radix 2 or 4 — natural
    order in and out, no bit-reversal;
  * ``ntt_four_step``: the C x R matrix-Fourier decomposition;
  * ``ntt_auto``: the entry point. It runs the fused two-pass transform
    of ``kernels/ntt_mfa.py``: the Hopper kernels on a CUDA tensor, their
    plain versions on a CPU tensor;
  * ``ntt_host`` / ``naive_dft``: numpy oracles.

Layout: the transform runs along **axis 0**; trailing axes are
independent lanes. Convention (pinned; defines bit-exactness):
  forward:  X[k] = sum_n x[n] * w^(n*k) mod p,   w = field.root_of_order(N)
  inverse:  x[n] = N^-1 * sum_k X[k] * w^(-n*k) mod p
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import gf
from .fields import FieldSpec, FIELDS


def _log2(n: int) -> int:
    t = n.bit_length() - 1
    assert 1 << t == n, f"size must be a power of two, got {n}"
    return t


# ---------------------------------------------------------------------------
# Host-side twiddle machinery (numpy; copied from the reference).
# ---------------------------------------------------------------------------

def powers_host(field: FieldSpec, base: int, count: int) -> np.ndarray:
    """[base^0, base^1, ..., base^(count-1)] mod p as numpy uint32
    (vectorized u64 doubling: out[f:2f] = out[:f] * base^f)."""
    if count <= 0:
        return np.empty(0, dtype=np.uint32)
    p = np.uint64(field.p)
    out = np.empty(count, dtype=np.uint64)
    out[0] = 1
    filled, step = 1, np.uint64(base % field.p)
    while filled < count:
        take = min(filled, count - filled)
        out[filled:filled + take] = out[:take] * step % p
        filled += take
        step = step * step % p
    return out.astype(np.uint32)


def powers_outer_host(field: FieldSpec, bases: np.ndarray,
                      count: int) -> np.ndarray:
    """[len(bases), count] table T[i, j] = bases[i]^j mod p."""
    m = int(np.asarray(bases).shape[0])
    if count <= 0 or m == 0:
        return np.empty((m, max(count, 0)), dtype=np.uint32)
    p = np.uint64(field.p)
    out = np.empty((m, count), dtype=np.uint64)
    out[:, 0] = 1
    filled = 1
    step = np.asarray(bases, dtype=np.uint64) % p
    while filled < count:
        take = min(filled, count - filled)
        out[:, filled:filled + take] = out[:, :take] * step[:, None] % p
        filled += take
        step = step * step % p
    return out.astype(np.uint32)


def prepare_consts(field: FieldSpec, vals: np.ndarray) -> np.ndarray:
    """Prepare constants for the device multiply: GF32 scales into the
    Montgomery domain (``mont_mul(x, prepared) == x * c``); GF16 is the
    identity."""
    if field.use_mont:
        return ((np.asarray(vals).astype(np.uint64) << np.uint64(32))
                % np.uint64(field.p)).astype(np.uint32)
    return np.asarray(vals).astype(np.uint32)


def _assert_gf16_stage_table(field: FieldSpec, vals: np.ndarray):
    """A GF16 stage table must be 0x10000-free: the butterfly multiply
    (:func:`gf._mul_gf16_tw`) is wrong for b = 0x10000."""
    if not field.use_mont:
        assert not (np.asarray(vals) == 0x10000).any(), (
            "GF16 stage table contains -1 (0x10000): the tw-specialized "
            "butterfly multiply would be wrong")
    return vals


@functools.lru_cache(maxsize=None)
def _stage_twiddles(field_name: str, a: int, inverse: bool):
    """Prepared twiddles w_a^j, j in [0, a/2), for a Stockham stage of
    size a (shared by every transform size)."""
    field = FIELDS[field_name]
    w = field.root_of_order(a)
    if inverse:
        w = field.inv_host(w)
    return _assert_gf16_stage_table(field, np.asarray(
        prepare_consts(field, powers_host(field, w, a // 2))))


@functools.lru_cache(maxsize=None)
def _r4_twiddles(field_name: str, a: int, inverse: bool):
    """Prepared (w^j, i4 broadcast, w^2j, w^3j) tables for a radix-4
    stage of size a, j in [0, a/4); i4 = w^(a/4)."""
    field = FIELDS[field_name]
    w = field.root_of_order(a)
    if inverse:
        w = field.inv_host(w)
    q = a // 4
    w1 = powers_host(field, w, q)
    i4 = np.full(q, field.pow_host(w, q), dtype=np.uint32)
    w2 = powers_host(field, field.pow_host(w, 2), q)
    w3 = powers_host(field, field.pow_host(w, 3), q)
    return tuple(_assert_gf16_stage_table(
        field, np.asarray(prepare_consts(field, v)))
        for v in (w1, i4, w2, w3))


@functools.lru_cache(maxsize=None)
def _four_step_twiddles(field_name: str, n: int, c: int, inverse: bool):
    """Prepared [C, R] table T[k_c, r] = w_N^(+-k_c * r)."""
    field = FIELDS[field_name]
    r_dim = n // c
    w = field.root_of_order(n)
    if inverse:
        w = field.inv_host(w)
    col = powers_host(field, w, c)
    rows = powers_outer_host(field, col, r_dim)
    return np.asarray(prepare_consts(field, rows))


@functools.lru_cache(maxsize=None)
def _pre_powers(field_name: str, g: int, n: int):
    field = FIELDS[field_name]
    return np.asarray(prepare_consts(field, powers_host(field, g, n)))


# ---------------------------------------------------------------------------
# Prepared multiplies.
# ---------------------------------------------------------------------------

def mul_prepared(field: FieldSpec, x, prepared):
    """x * c mod p where ``prepared`` came from :func:`prepare_consts`."""
    if field.use_mont:
        return gf.mont_mul(field, x, prepared)
    return gf._mul_gf16(x, prepared)


def mul_prepared_tw(field: FieldSpec, x, prepared):
    """x * c mod p where ``prepared`` is a BUTTERFLY STAGE table entry
    (GF16: the escape-free form; never for four-step, coset or
    scale-folded tables, which can hold 0x10000)."""
    if field.use_mont:
        return gf.mont_mul(field, x, prepared)
    return gf._mul_gf16_tw(x, prepared)


# ---------------------------------------------------------------------------
# Stockham autosort NTT (plain PyTorch).
# ---------------------------------------------------------------------------

def ntt(x: torch.Tensor, field: FieldSpec, inverse: bool = False,
        scale: bool = True, radix: int = 2) -> torch.Tensor:
    """Length-N NTT along axis 0; natural order in and out.

    Each Stockham DIF stage splits every pending sub-transform into
    even/odd halves with one butterfly over contiguous slices and
    prepends the new output bit to the completed axis. ``radix=4`` merges
    stage pairs (a leading radix-2 stage handles odd log2 N); bit-exact
    equal to radix 2. ``scale`` controls the inverse's final N^-1."""
    assert radix in (2, 4)
    (y,), u = gf._carried(x)
    n = y.shape[0]
    t = _log2(n)
    rest = tuple(y.shape[1:])
    if t > 0:
        y = y.reshape((n, 1) + rest)
        s = 0
        if radix == 4 and t % 2 == 1:
            y = _stage_r2(y, field, n, 0, inverse, rest)
            s = 1
        while s < t:
            if radix == 4 and s + 1 < t:
                y = _stage_r4(y, field, n, s, inverse, rest)
                s += 2
            else:
                y = _stage_r2(y, field, n, s, inverse, rest)
                s += 1
        y = y.reshape((n,) + rest)
        if inverse and scale:
            y = gf.mul_const(field, y, field.inv_host(n))
    return gf._ret(y, u)


def _stage_r2(y, field: FieldSpec, n: int, s: int, inverse: bool, rest):
    """One radix-2 Stockham DIF stage on y [a, done, *rest]."""
    a = n >> s
    half = a >> 1
    tw = gf.table(_stage_twiddles(field.name, a, inverse), y.device)
    tw = tw.reshape((half, 1) + (1,) * len(rest))
    lo, hi = y[:half], y[half:]
    even = gf.add(field, lo, hi)
    odd = mul_prepared_tw(field, gf.sub(field, lo, hi), tw)
    return torch.stack([even, odd], dim=1).reshape(
        (half, 2 * y.shape[1]) + rest)


def _stage_r4(y, field: FieldSpec, n: int, s: int, inverse: bool, rest):
    """One radix-4 stage == two fused radix-2 stages. With quarters
    q0..q3, w = w_a and i4 = w_a^(a/4), the slots (stage2_bit, stage1_bit)
    are (q0+q2)+(q1+q3), ((q0-q2)+i4(q1-q3))w^j, ((q0+q2)-(q1+q3))w^2j,
    ((q0-q2)-i4(q1-q3))w^3j."""
    a = n >> s
    q = a >> 2
    w1, i4, w2, w3 = (gf.table(v, y.device).reshape((q, 1) + (1,) * len(rest))
                      for v in _r4_twiddles(field.name, a, inverse))
    q0, q1, q2, q3 = y[:q], y[q:2 * q], y[2 * q:3 * q], y[3 * q:]
    s0, s1 = gf.add(field, q0, q2), gf.add(field, q1, q3)
    d0 = gf.sub(field, q0, q2)
    d1 = mul_prepared_tw(field, gf.sub(field, q1, q3), i4)
    o00 = gf.add(field, s0, s1)
    o10 = mul_prepared_tw(field, gf.sub(field, s0, s1), w2)
    o01 = mul_prepared_tw(field, gf.add(field, d0, d1), w1)
    o11 = mul_prepared_tw(field, gf.sub(field, d0, d1), w3)
    return torch.stack([o00, o01, o10, o11], dim=1).reshape(
        (q, 4 * y.shape[1]) + rest)


def intt(x: torch.Tensor, field: FieldSpec, scale: bool = True):
    """Inverse NTT along axis 0 (w^-1 twiddles + N^-1 scale)."""
    return ntt(x, field, inverse=True, scale=scale)


def ntt_four_step(x: torch.Tensor, field: FieldSpec, inverse: bool = False,
                  c_dim: int | None = None, scale: bool = True):
    """N-point NTT along axis 0 via the four-step C x R decomposition:
    with n = r + R*c and k = k_c + C*k_r, C-point NTTs along c, a twiddle
    w_N^(k_c*r), R-point NTTs along r, and a transpose. Bit-exact equal
    to :func:`ntt`."""
    (x,), u = gf._carried(x)
    n = x.shape[0]
    t = _log2(n)
    if c_dim is None:
        c_dim = 1 << (t // 2)
    r_dim = n // c_dim
    assert c_dim * r_dim == n and c_dim > 1 and r_dim > 1
    rest = tuple(x.shape[1:])
    y = x.reshape((c_dim, r_dim) + rest)
    y = ntt(y, field, inverse=inverse, scale=False)
    tw = gf.table(_four_step_twiddles(field.name, n, c_dim, inverse),
                  x.device)
    y = mul_prepared(field, y, tw.reshape((c_dim, r_dim) + (1,) * len(rest)))
    y = torch.movedim(y, 1, 0)
    y = ntt(y, field, inverse=inverse, scale=False)
    out = y.reshape((n,) + rest)
    if inverse and scale:
        out = gf.mul_const(field, out, field.inv_host(n))
    return gf._ret(out, u)


def ntt_auto(x, field: FieldSpec, inverse: bool = False, scale: bool = True,
             pre_seed: int | None = None, pre_vec=None, post_vec=None,
             sel_mask=None, sel_orig=None, device=None) -> torch.Tensor:
    """The transform entry point: NTT along axis 0 of a u32 [N, ...]
    tensor (trailing axes are lanes) through the fused two-pass transform
    (``kernels.ntt_mfa.ntt_fused``). On a CUDA tensor that is always the
    Hopper kernels — pass A (K1, or K4 with ``pre_seed``) then pass B
    (K3); on a CPU tensor it is their plain versions. ``pre_seed=g``
    applies the input multiply x[m] *= g^m. A numpy input goes to
    ``device`` (default: the card).

    ``pre_vec``, ``post_vec`` and ``sel_mask``/``sel_orig`` are decode's
    fusions (kernels K5-K7), not yet ported."""
    from .interop import as_tensor
    from .kernels import ntt_mfa

    if any(v is not None for v in (pre_vec, post_vec, sel_mask, sel_orig)):
        raise NotImplementedError(
            "pre_vec/post_vec/sel_* are decode fusions (kernels K5-K7), "
            "not yet ported")
    x = as_tensor(x, device)
    n = x.shape[0]
    y = ntt_mfa.ntt_fused(x.reshape(n, -1), field, inverse=inverse,
                          scale=scale, pre_seed=pre_seed)
    return y.reshape(x.shape)


# ---------------------------------------------------------------------------
# Host oracles (numpy).
# ---------------------------------------------------------------------------

def ntt_host(x: np.ndarray, field: FieldSpec, inverse: bool = False,
             scale: bool = True) -> np.ndarray:
    """Stockham NTT along axis 0 in numpy; bit-exact equal to :func:`ntt`."""
    x = np.asarray(x)
    n = x.shape[0]
    t = _log2(n)
    rest = x.shape[1:]
    if t == 0:
        return x.astype(np.uint32)
    p = np.uint64(field.p)
    y = x.reshape((n, 1) + rest).astype(np.uint64)
    for s in range(t):
        a = n >> s
        half = a >> 1
        w = field.root_of_order(a)
        if inverse:
            w = field.inv_host(w)
        tw = powers_host(field, w, half).astype(np.uint64).reshape(
            (half, 1) + (1,) * len(rest))
        lo, hi = y[:half], y[half:]
        even = (lo + hi) % p
        odd = (lo + p - hi) % p * tw % p
        y = np.stack([even, odd], axis=1).reshape(
            (half, 2 * y.shape[1]) + rest)
    out = y.reshape((n,) + rest)
    if inverse and scale:
        out = out * np.uint64(field.inv_host(n)) % p
    return out.astype(np.uint32)


def naive_dft(x: np.ndarray, field: FieldSpec, inverse: bool = False):
    """Exact bigint DFT along axis 0. Only for small N in tests."""
    x = np.asarray(x)
    n = x.shape[0]
    w = field.root_of_order(n)
    if inverse:
        w = field.inv_host(w)
    mat = np.empty((n, n), dtype=object)
    for j in range(n):
        mat[j] = powers_host(field, field.pow_host(w, j), n).astype(object)
    flat = x.reshape(n, -1).astype(object)
    out = (mat @ flat) % field.p
    if inverse:
        out = (out * field.inv_host(n)) % field.p
    return out.reshape(x.shape).astype(np.uint32)
