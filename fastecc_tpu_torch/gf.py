"""GF(p) arithmetic in plain PyTorch: the port's counterpart of ``gf.py``.

Public tensors are ``torch.uint32``, but PyTorch has no arithmetic on
``uint32`` (the CPU build refuses even an add), so every function widens
its operands to **int64 carriers** holding values in [0, 2^32), computes
there and narrows back. Functions are dtype-preserving: ``uint32`` in,
``uint32`` out; int64 carriers in, int64 carriers out — the plain
transforms widen once at their entry and stay in carriers across stages.

An int64 product of two 32-bit residues can overflow, so the 64-bit
product is built from 16-bit limbs (:func:`_mul_wide`), as the reference
builds it for the TPU, and every step that wraps mod 2^32 in u32
arithmetic is masked explicitly. The results are canonical residues, bit
for bit those of the JAX package.

Conventions (as in the reference):
  * field elements are normal-domain values < p (GF16: <= 0x10000);
  * hot-path multiplies use Montgomery-prepared constants (GF32):
    ``mont_mul(x, c * 2^32 mod p) == x * c mod p``;
  * GF16 needs no preparation (Fermat reduction 2^16 = -1 mod p).

The CUDA kernels (``csrc/gf.cuh``) compute the same residues with the
card's native 32x32 -> 64 product.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields import FieldSpec, GF16

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


# ---------------------------------------------------------------------------
# u32 <-> int64 carriers.
# ---------------------------------------------------------------------------

def widen(x: torch.Tensor) -> torch.Tensor:
    """``torch.uint32`` -> int64 carrier (zero-extended)."""
    return x.view(torch.int32).to(torch.int64) & MASK32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 carrier with values in [0, 2^32) -> ``torch.uint32``."""
    return (x - ((x >> 31) << 32)).to(torch.int32).view(torch.uint32)


def table(vals: np.ndarray, device) -> torch.Tensor:
    """Host u32 table -> int64 carrier on ``device``."""
    return torch.from_numpy(np.asarray(vals, dtype=np.int64)).to(device)


def _carried(*xs):
    """(operands as carriers, whether the result narrows back to u32)."""
    is_u32 = any(isinstance(x, torch.Tensor) and x.dtype == torch.uint32
                 for x in xs)
    out = tuple(widen(x) if isinstance(x, torch.Tensor)
                and x.dtype == torch.uint32 else x for x in xs)
    return out, is_u32


def _ret(x, is_u32: bool):
    return narrow(x) if is_u32 else x


# ---------------------------------------------------------------------------
# add / sub / neg.
# ---------------------------------------------------------------------------

def add(field: FieldSpec, a, b):
    """(a + b) mod p, elementwise (a, b < p; GF16 <= 0x10000)."""
    (a, b), u = _carried(a, b)
    s = a + b
    return _ret(torch.where(s >= field.p, s - field.p, s), u)


def sub(field: FieldSpec, a, b):
    """(a - b) mod p, elementwise."""
    (a, b), u = _carried(a, b)
    d = a - b
    return _ret(torch.where(d < 0, d + field.p, d), u)


def neg(field: FieldSpec, a):
    (a,), u = _carried(a)
    return _ret(torch.where(a == 0, a, field.p - a), u)


# ---------------------------------------------------------------------------
# 64-bit product from 16-bit limbs.
# ---------------------------------------------------------------------------

def _mul_wide(a, b):
    """Full 64-bit product of two u32 carriers as a (hi, lo) pair of u32
    carriers. Four 16x16 -> 32 partial products; no intermediate
    exceeds 2^34, so int64 never overflows."""
    (a, b), u = _carried(a, b)
    al, ah = a & _MASK16, a >> 16
    bl, bh = b & _MASK16, b >> 16
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    t = (ll >> 16) + (lh & _MASK16) + (hl & _MASK16)       # < 2^18
    lo = ((t << 16) & MASK32) | (ll & _MASK16)
    hi = hh + (lh >> 16) + (hl >> 16) + (t >> 16)
    return _ret(hi, u), _ret(lo, u)


# ---------------------------------------------------------------------------
# Montgomery multiplication (GF32).
# ---------------------------------------------------------------------------

def mont_mul(field: FieldSpec, a, b, generic: bool = False):
    """REDC(a * b) = a * b * 2^-32 mod p. Requires a, b < p.

    With b = c * 2^32 mod p (a prepared constant) the result is a * c mod
    p. For p = 0xFFF00001 the REDC multiplies collapse to shifts
    (n' = p - 2): m = -(lo + (lo << 20)) and
    (m * p) >> 32 = m - (m >> 12) - [m < ((m & 0xFFF) << 20)].
    ``generic=True`` forces the limb-product REDC for any Montgomery
    prime; the two branches are bit-identical."""
    assert field.use_mont
    (a, b), u = _carried(a, b)
    hi, lo = _mul_wide(a, b)
    if field.p == 0xFFF00001 and not generic:
        m = (-(lo + (lo << 20))) & MASK32
        s20 = (m & 0xFFF) << 20
        mp_hi = (m - (m >> 12) - (m < s20).to(torch.int64)) & MASK32
    else:
        _, m = _mul_wide(lo, field.n_prime)
        mp_hi, _ = _mul_wide(m, field.p)
    # t + m*p has a zero low word; the carry out of it is 1 iff lo != 0.
    carry = (lo != 0).to(torch.int64)
    s = hi + mp_hi + carry                                  # < 2p
    return _ret(torch.where(s >= field.p, s - field.p, s), u)


def to_mont(field: FieldSpec, a):
    """a -> a * 2^32 mod p (enter the Montgomery domain)."""
    return mont_mul(field, a, field.r2_mod_p)


def from_mont(field: FieldSpec, a):
    """a * 2^32 mod p -> a (leave the Montgomery domain)."""
    return mont_mul(field, a, 1)


# ---------------------------------------------------------------------------
# GF16 and the general normal-domain multiply.
# ---------------------------------------------------------------------------

def _mul_gf16(a, b):
    """(a * b) mod 0x10001 with operands in [0, 0x10000].

    The u32 product wraps only for 0x10000 * 0x10000 = 2^32, and
    2^32 mod p = 1 restores it; reduction uses 2^16 = -1 (mod p)."""
    (a, b), u = _carried(a, b)
    p = GF16.p
    t = (a * b) & MASK32
    ov = ((a == 0x10000) & (b == 0x10000)).to(torch.int64)
    lo, hi = t & _MASK16, t >> 16
    r = torch.where(lo >= hi, lo - hi, lo - hi + p) + ov
    return _ret(torch.where(r >= p, r - p, r), u)


def _mul_gf16_tw(a, b):
    """(a * b) mod 0x10001 with a <= 0x10000 and b STRICTLY below 2^16 —
    the butterfly-twiddle form. Stage tables never hold 0x10000 (= -1),
    so the product never wraps and lo16 - hi16 lands in (-2^16, 2^16):
    the wrap fix and the final select drop out. Wrong for four-step,
    coset or scale-folded tables, which can hold 0x10000."""
    (a, b), u = _carried(a, b)
    t = a * b
    lo, hi = t & _MASK16, t >> 16
    return _ret(torch.where(lo >= hi, lo - hi, lo - hi + GF16.p), u)


def mul(field: FieldSpec, a, b):
    """(a * b) mod p for arbitrary normal-domain operands < p."""
    if field.use_mont:
        return mont_mul(field, mont_mul(field, a, b), field.r2_mod_p)
    return _mul_gf16(a, b)


def mul_const(field: FieldSpec, a, c: int):
    """a * c mod p where c is a Python-int constant (prepared here)."""
    if field.use_mont:
        return mont_mul(field, a, field.to_mont_host(c))
    return _mul_gf16(a, c % field.p)


# ---------------------------------------------------------------------------
# pow / inverse: square-and-multiply.
# ---------------------------------------------------------------------------

def pow_const(field: FieldSpec, a, e: int):
    """a ** e mod p with a Python-int exponent (negative e: inverse
    powers). Fermat's e mod (p-1) holds only for nonzero bases, so a
    nonzero e that reduces to 0 becomes p-1: 0 ** (m*(p-1)) stays 0."""
    orig_nonzero = e != 0
    e %= field.p - 1
    if e == 0 and orig_nonzero:
        e = field.p - 1
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(field, result, base)
        e >>= 1
        if e:
            base = mul(field, base, base)
    if result is None:
        return torch.ones_like(a)
    return result


def inv(field: FieldSpec, a):
    """Elementwise inverse a^(p-2) mod p; inv(0) = 0."""
    return pow_const(field, a, field.p - 2)


def pow_base(field: FieldSpec, base: int, e: torch.Tensor):
    """base ** e mod p for a Python-int base and a tensor of exponents
    e < 2^(max_log2+1) (square-and-multiply over the bits of e; the
    twiddles w^j at erasure positions j). u32 exponents give u32 results,
    int64 exponents int64 carriers."""
    (ew,), u = _carried(e)
    result = torch.ones_like(ew, dtype=torch.int64)
    sq = base % field.p
    for t in range(field.max_log2 + 1):
        stepped = mul_const(field, result, sq)
        result = torch.where(((ew >> t) & 1) == 1, stepped, result)
        sq = sq * sq % field.p
    return _ret(result, u)


def prepare_device(field: FieldSpec, v):
    """Prepare values computed on the device for the table multiply (the
    device-side ``ntt.prepare_consts``): GF32 enters the Montgomery
    domain, GF16 is the identity."""
    if field.use_mont:
        return to_mont(field, v)
    return v


def mul_prepared_device(field: FieldSpec, x, prepared):
    """x * v mod p where ``prepared = prepare_device(field, v)``."""
    if field.use_mont:
        return mont_mul(field, x, prepared)
    return _mul_gf16(x, prepared)
