"""Reed-Solomon decoding in O(n log n): the port's counterpart of
``decode.py`` (erasure decode and unknown-position error correction).

Scheme (as the reference). Codeword c_j = f(w^j) with deg f < k; erasures
E, |E| = e <= n - k:

  1. Locator l(x) = prod_{j in E} (x - w^j), as coefficients from a
     log-depth product tree: level i multiplies pairs of monic degree-2^i
     polynomials with NTT convolutions of size 2^(i+1). Monic polynomials
     are stored without their leading 1, so a level is a dense [d, m]
     array (d coefficients of m polynomials).
  2. h = f * l has deg < n and h(w^j) = c_j * l(w^j) (zero at erasures),
     so h's coefficients are iNTT_n(c * l(w)).
  3. Forney with the unshifted derivative: at an erased j,
     c_j = (x h')(w^j) / (x l')(w^j); the coefficients of x h' are m h_m.

So the decode is one transform pair with a table fused into each pass:
``decode_prepared`` runs ``ntt_pair`` as K5 (x l(w^j)) -> K6 (x m) ->
K7-sel (x inv(x l'), then the erased-row merge), or K7 without the merge.
The tables (mask, prepared l(w^j), prepared inv(x l')) come from the host
(``locator_host``, numpy) or from the device (``prepare_decode_tables_
device``: the product tree's transforms on the kernels).

Error correction (``locate_errors``, ``correct_errors``,
``decode_blocks(check=True)``) finds up to (n-k)/2 silently corrupted rows
at unknown positions, or e + 2t <= n-k together with e known erasures:
power-sum syndromes from one inverse transform and two random lane
combinations, Berlekamp-Massey on the host, the locator's roots from one
forward transform, then the erasure decode of the located rows. It adds
no kernel: the transforms run K1/K5 -> K3 and the decode K5 -> K6 ->
K7-sel.

Entry points take u32 tensors or numpy arrays with the transform along
axis 0 and lanes trailing; a numpy input goes to ``device`` (default: the
card). Where the reference asserts, the port raises ``ValueError``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import gf, packing
from .fields import FieldSpec, FIELDS
from .interop import as_tensor, resolve_device, to_numpy_u32
from .kernels import ntt_mfa
from .ntt import _log2, mul_prepared, ntt_auto, ntt_host, prepare_consts
from .rs import data_positions, parity_positions  # noqa: F401 (re-export)
from .rs import _chunk, _upload, stream_lane_chunks, verify_codeword
from .utils import profiling


@functools.lru_cache(maxsize=None)
def _xderiv_consts(field_name: str, n: int):
    """Prepared [n] table of m mod p: coefficient-wise x * d/dx (the
    UNSHIFTED derivative, fusable as a transform input-side multiply)."""
    field = FIELDS[field_name]
    vals = (np.arange(n, dtype=np.uint64) % field.p).astype(np.uint32)
    return np.asarray(prepare_consts(field, vals))


@functools.lru_cache(maxsize=None)
def _xderiv_on(field_name: str, n: int, device: str) -> torch.Tensor:
    return as_tensor(_xderiv_consts(field_name, n), device)


def _check_recoverable(e: int, n: int, k: int | None) -> None:
    """Information-theoretic guard: recovery needs e <= n - k
    (deg(f*l) < n); beyond that an erasure decoder returns garbage."""
    if k is not None and e > n - k:
        raise ValueError(
            f"unrecoverable: {e} erasures > n - k = {n - k} "
            f"(an [n={n}, k={k}] code tolerates at most n-k losses)")


def _check_erasures(e: int, n: int) -> None:
    _log2(n)
    if not 1 <= e < n:
        raise ValueError(f"need 1 <= erasures < n, got {e} of n={n}")


# ---------------------------------------------------------------------------
# Device locator: the product tree on int64 carriers, its transforms on
# ntt_auto (the kernels on a CUDA tensor).
# ---------------------------------------------------------------------------

def _ntt_c(x: torch.Tensor, field: FieldSpec, inverse: bool = False):
    """ntt_auto on an int64 carrier array (the kernels take u32)."""
    return gf.widen(ntt_auto(gf.narrow(x), field, inverse=inverse))


def _tree_pow2(neg_roots: torch.Tensor, field: FieldSpec):
    """Stored coeffs [e] of prod (x - r) over e >= 2 roots, e a power of
    two (``neg_roots`` holds -r as int64 carriers).

    Level d holds [d, m] (m polys, d coefficients each, coefficient-major
    so the NTT runs on axis 0); one level = batched size-2d NTT
    convolutions. The first level, 2-point convolutions below the
    kernels' order 4, is the product (x + a)(x + b) written out as the
    stored coefficients (a*b, a + b): the residues the size-2 transforms
    give."""
    a_, b_ = neg_roots[0::2], neg_roots[1::2]
    a = torch.stack([gf.mul(field, a_, b_), gf.add(field, a_, b_)])
    d, m = 2, neg_roots.shape[0] // 2
    while m > 1:
        lhs, rhs = a[:, 0::2], a[:, 1::2]                  # [d, m/2] each
        pad = torch.zeros_like(lhs)
        fa = _ntt_c(torch.cat([lhs, pad]), field)         # [2d, m/2]
        fb = _ntt_c(torch.cat([rhs, pad]), field)
        prod = _ntt_c(gf.mul(field, fa, fb), field, inverse=True)
        # (x^d + a)(x^d + b) = x^2d + (a+b) x^d + a*b; store without x^2d
        hi = gf.add(field, prod[d:], gf.add(field, lhs, rhs))
        a = torch.cat([prod[:d], hi])
        d, m = 2 * d, m // 2
    return a[:, 0]


def _mul_monic(a: torch.Tensor, b: torch.Tensor, field: FieldSpec):
    """Stored coeffs [d1+d2] of the product of two stored monic polys
    (int64 carriers; d1 + d2 >= 3, so the convolution has order >= 4)."""
    d1, d2 = a.shape[0], b.shape[0]
    size = 1 << (d1 + d2 - 1).bit_length()
    fa = _ntt_c(torch.cat([a, a.new_zeros(size - d1)]), field)
    fb = _ntt_c(torch.cat([b, b.new_zeros(size - d2)]), field)
    conv = _ntt_c(gf.mul(field, fa, fb), field, inverse=True)[:d1 + d2]
    # (x^d1 + a)(x^d2 + b) = x^(d1+d2) + x^d2*a + x^d1*b + a*b
    conv = conv.clone()
    conv[d2:d2 + d1] = gf.add(field, conv[d2:d2 + d1], a)
    conv[d1:d1 + d2] = gf.add(field, conv[d1:d1 + d2], b)
    return conv


def _loc_stored(neg_roots: torch.Tensor, field: FieldSpec):
    """Stored locator coeffs for any root count: largest power-of-two
    subtree + recursive remainder, merged with a monic multiply."""
    e = neg_roots.shape[0]
    if e == 1:
        return neg_roots
    t = 1 << (e.bit_length() - 1)
    if t == e:
        return _tree_pow2(neg_roots, field)
    return _mul_monic(_tree_pow2(neg_roots[:t], field),
                      _loc_stored(neg_roots[t:], field), field)


def _positions(erased_idx, device) -> torch.Tensor:
    """Erasure positions (tensor, array or list) as int64 on ``device``."""
    if isinstance(erased_idx, torch.Tensor):
        return erased_idx.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(erased_idx, np.int64)).to(device)


def locator_coeffs(erased_idx, n: int, field: FieldSpec, device=None):
    """Coefficients [e+1] (u32) of l(x) = prod_{j in E} (x - w_n^j), any
    e >= 1, constant term first, leading 1 last. Positions must be
    distinct; a tensor keeps its device, anything else goes to
    ``device`` (default: the card)."""
    idx = _positions(erased_idx, erased_idx.device if isinstance(
        erased_idx, torch.Tensor) else resolve_device(device))
    roots = gf.pow_base(field, field.root_of_order(n), idx)   # w^j
    stored = _loc_stored(gf.neg(field, roots), field)
    return gf.narrow(torch.cat([stored, stored.new_ones(1)]))


def _decode_tables_device(erased_idx: torch.Tensor, n: int,
                          field: FieldSpec):
    """The decode tables from erasure positions (an int tensor), built on
    its device: the locator product tree, both evaluation transforms as
    one [n, 2] transform, and the batched inversion. Bit-exact vs
    :func:`locator_host`."""
    idx = erased_idx.to(torch.int64)
    e = idx.shape[0]
    mask = torch.zeros(n, dtype=torch.int64, device=idx.device)
    mask[idx] = 1
    lc = gf.widen(locator_coeffs(idx, n, field))          # [e+1]
    lpad = torch.cat([lc, lc.new_zeros(n - e - 1)])
    dx = gf.widen(_xderiv_on(field.name, n, str(idx.device)))
    lpx = mul_prepared(field, lpad, dx)                    # x*l' coefficients
    both = _ntt_c(torch.stack([lpad, lpx], dim=1), field)  # [n, 2]
    lp_inv = gf.inv(field, both[:, 1])
    return (gf.narrow(mask), gf.narrow(gf.prepare_device(field, both[:, 0])),
            gf.narrow(gf.prepare_device(field, lp_inv)))


def prepare_decode_tables_device(erased_idx, n: int, field: FieldSpec,
                                 device=None):
    """(mask [n], prepared l(w^j) [n], prepared inv(x l')(w^j) [n]), u32,
    built on ``device`` (default: the card) by the device product tree.
    On a card its transforms run on the kernels."""
    idx = _positions(erased_idx, resolve_device(device))
    _check_erasures(int(idx.shape[0]), n)
    return _decode_tables_device(idx, n, field)


# ---------------------------------------------------------------------------
# Host locator (numpy u64): the same tree on the host.
# ---------------------------------------------------------------------------

def _inv_host_vec(a: np.ndarray, field: FieldSpec) -> np.ndarray:
    """Elementwise a^(p-2) mod p, vectorized square-and-multiply."""
    p = np.uint64(field.p)
    e = field.p - 2
    result = np.ones_like(a, dtype=np.uint64)
    base = a.astype(np.uint64)
    while e:
        if e & 1:
            result = result * base % p
        e >>= 1
        if e:
            base = base * base % p
    return result.astype(np.uint32)


def locator_host(erased_idx: np.ndarray, n: int, field: FieldSpec):
    """Host numpy build of the decode tables for erasure set E.

    Returns (l_eval [n], lp_inv [n]) where l_eval[j] = l(w^j) for
    l(x) = prod_{i in E} (x - w^i), and lp_inv[j] = inv(w^j * l'(w^j)) at
    erased j (other entries are don't-care): the UNSHIFTED x*l'
    convention, which decode pairs with evaluations of x*h'(x)
    (coefficients m*h_m) so that the w^j factors cancel in the Forney
    quotient. Bit-exact vs the device tables. The transforms and
    multiplies run on the native host library when it is loaded (the
    same bits, on every core), numpy otherwise."""
    from . import host

    p = np.uint64(field.p)
    native = host.available()
    nth = host.ntt if native else ntt_host

    def mm(a, b):
        if native:
            return host.mulmod(a, b, field)
        return (a.astype(np.uint64) * b % p).astype(np.uint32)

    erased_idx = np.asarray(erased_idx, dtype=np.uint64)
    e = int(erased_idx.shape[0])
    _check_erasures(e, n)
    w = field.root_of_order(n)
    # roots w^i via host pow (vectorized square-and-multiply over bits of i)
    roots = np.ones(e, dtype=np.uint64)
    sq = np.uint64(w)
    for t in range(field.max_log2 + 1):
        bit = (erased_idx >> np.uint64(t)) & np.uint64(1)
        stepped = roots * sq % p
        roots = np.where(bit == 1, stepped, roots)
        sq = sq * sq % p
    neg = np.where(roots == 0, roots, p - roots).astype(np.uint32)

    # product tree over monic (x - r) factors, stored without leading 1;
    # the level structure of the device tree
    def tree_pow2(nr):
        a = nr.reshape(1, -1)
        d, m = 1, nr.shape[0]
        while m > 1:
            lhs, rhs = a[:, 0::2], a[:, 1::2]
            pad = np.zeros((d, m // 2), np.uint32)
            fa = nth(np.concatenate([lhs, pad], axis=0), field)
            fb = nth(np.concatenate([rhs, pad], axis=0), field)
            prod = nth(mm(fa, fb), field, inverse=True)
            hi = (prod[d:].astype(np.uint64) + lhs + rhs) % p
            a = np.concatenate([prod[:d].astype(np.uint64), hi],
                               axis=0).astype(np.uint32)
            d, m = 2 * d, m // 2
        return a[:, 0]

    def mul_monic(a, b):
        d1, d2 = a.shape[0], b.shape[0]
        size = 1 << (d1 + d2 - 1).bit_length()
        fa = nth(np.concatenate([a, np.zeros(size - d1, np.uint32)]), field)
        fb = nth(np.concatenate([b, np.zeros(size - d2, np.uint32)]), field)
        conv = nth(mm(fa, fb), field, inverse=True)[: d1 + d2].astype(
            np.uint64)
        conv[d2: d2 + d1] = (conv[d2: d2 + d1] + a) % p
        conv[d1: d1 + d2] = (conv[d1: d1 + d2] + b) % p
        return conv.astype(np.uint32)

    def loc_stored(nr):
        m = nr.shape[0]
        if m == 1:
            return nr
        t = 1 << (m.bit_length() - 1)
        if t == m:
            return tree_pow2(nr)
        return mul_monic(tree_pow2(nr[:t]), loc_stored(nr[t:]))

    lc = np.concatenate([loc_stored(neg), np.ones(1, np.uint32)])  # [e+1]
    lpad = np.concatenate([lc, np.zeros(n - e - 1, np.uint32)])
    l_eval = nth(lpad, field)                             # l(w^j)
    # coefficients of x*l'(x) are m*l_m (no index shift)
    deriv = lc.astype(np.uint64) * (np.arange(e + 1, dtype=np.uint64)
                                    % p) % p
    dpad = np.concatenate([deriv.astype(np.uint32),
                           np.zeros(n - e - 1, np.uint32)])
    lp_inv = _inv_host_vec(nth(dpad, field), field)  # 1/(w^j l'(w^j))
    return l_eval, lp_inv


def prepare_decode_tables(erased_idx, n: int, field: FieldSpec,
                          locator: str = "auto", device=None):
    """The decode tables (mask [n], prepared l(w^j) [n], prepared
    inv(x l')(w^j) [n]) as u32 tensors on ``device`` (default: the card)
    for :func:`decode_prepared`. Build once per erasure pattern and reuse
    across codewords.

    ``locator`` picks where the product tree runs: "host" (numpy),
    "device" (:func:`prepare_decode_tables_device`), or "auto": the
    device when the tables go to a card and e >= 4096, else the host."""
    if locator not in ("auto", "host", "device"):
        raise ValueError(f"locator must be auto, host or device, got "
                         f"{locator!r}")
    dev = resolve_device(device)
    erased = _positions(erased_idx, "cpu").numpy()
    e = int(erased.shape[0])
    if locator == "auto":
        locator = "device" if dev.type == "cuda" and e >= 4096 else "host"
    if locator == "device":
        return prepare_decode_tables_device(erased, n, field, dev)
    l_eval, lp_inv = locator_host(erased, n, field)
    mask = np.zeros(n, np.uint32)
    mask[erased] = 1
    return (as_tensor(mask, dev),
            as_tensor(np.asarray(prepare_consts(field, l_eval)), dev),
            as_tensor(np.asarray(prepare_consts(field, lp_inv)), dev))


# ---------------------------------------------------------------------------
# Decode entry points.
# ---------------------------------------------------------------------------

def decode_prepared(codeword, mask, l_eval_prep, lp_inv_prep,
                    field: FieldSpec, merge: bool = True,
                    device=None) -> torch.Tensor:
    """Recover the erased rows of a [n, ...] u32 codeword from the tables
    of :func:`prepare_decode_tables`, in one three-pass transform pair
    (``ntt_pair``):

      * A1 (K5): x l(w^j), which forms h = c*l and zeroes the erased rows'
        garbage in one multiply, then the inverse columns;
      * the seam (K6): x m, the coefficients of x*h'(x);
      * B2 (K7-sel): x inv(x l'(w^j)) (the Forney quotient), then the
        merge where(mask, recovered, codeword).

    ``merge=False`` runs K7 instead and returns the raw Forney product:
    right ONLY at erased rows, garbage elsewhere (for callers that merge
    from their own survivor copies). With the pair switch
    (``ntt_mfa.PAIR_ENABLED``) off the same multiplies ride two staged
    transforms, K5 -> K3 and K5 -> K7-sel (or K7). Runs inside the span
    ``fecc.decode.decode_prepared``."""
    with profiling.scope("fecc.decode.decode_prepared"):
        cw = as_tensor(codeword, device)
        n = cw.shape[0]
        x = cw.reshape(n, -1)
        dev = x.device
        mask, lp, ip = (as_tensor(t, dev) for t in (mask, l_eval_prep,
                                                     lp_inv_prep))
        dx = _xderiv_on(field.name, n, str(dev))
        sel = (mask, x) if merge else (None, None)
        if ntt_mfa._pair_supported(n):
            out = ntt_mfa.ntt_pair(x, field, pre_vec1=lp, pre_vec2=dx,
                                   post_vec=ip, sel_mask=sel[0],
                                   sel_orig=sel[1])
        else:
            # the pair switch is off (or the order is below the kernels'
            # split): two staged transforms, K5 -> K3 and K5 -> K7-sel
            # (K7 without the merge)
            h_coeffs = ntt_auto(x, field, inverse=True, pre_vec=lp)
            out = ntt_auto(h_coeffs, field, pre_vec=dx, post_vec=ip,
                           sel_mask=sel[0], sel_orig=sel[1])
        return out.reshape(cw.shape)


def decode_stream(codeword: np.ndarray, erased_idx, field: FieldSpec,
                  chunk_lanes: int = 1024, out: np.ndarray | None = None,
                  k: int | None = None, device=None) -> np.ndarray:
    """Out-of-core decode for codewords larger than device memory: the
    host [n, L] u32 codeword streams through ``device`` (default: the
    card) in ``chunk_lanes``-wide slices with the depth-2 pipeline of
    ``rs.stream_lane_chunks``; the tables are built once and every chunk
    runs :func:`decode_prepared`. Returns (or fills ``out`` with) the
    [n, L] host result, bit-identical to :func:`decode_host_prepared`.
    Pass ``k`` for the e <= n - k guard."""
    n, lanes = codeword.shape
    erased = _positions(erased_idx, "cpu").numpy()
    _check_recoverable(int(erased.size), n, k)
    chunk = _chunk(lanes, chunk_lanes)
    dev = resolve_device(device)
    tables = prepare_decode_tables(erased, n, field, device=dev)
    if out is None:
        out = np.empty((n, lanes), dtype=np.uint32)

    def dispatch(off):
        return decode_prepared(_upload(codeword[:, off:off + chunk], dev),
                               *tables, field)

    return stream_lane_chunks(lanes, chunk, dispatch, out, dev)


def decode_host_prepared(codeword, erased_idx, field: FieldSpec,
                         k: int | None = None, device=None) -> torch.Tensor:
    """Full decode with tables from :func:`prepare_decode_tables` on the
    codeword's device ("auto" locator). Pass ``k`` (the data-block count)
    to enforce the e <= n - k recoverability bound."""
    cw = as_tensor(codeword, device)
    n = cw.shape[0]
    erased = _positions(erased_idx, "cpu").numpy()
    _check_recoverable(int(erased.shape[0]), n, k)
    tables = prepare_decode_tables(erased, n, field, device=cw.device)
    return decode_prepared(cw, *tables, field)


def decode(codeword, erased_idx, field: FieldSpec, k: int | None = None,
           device=None) -> torch.Tensor:
    """Recover the erased rows of a codeword, all on its device.

    ``codeword`` is [n, lanes] u32 (rows in ``erased_idx`` may hold any
    garbage); ``erased_idx`` lists e >= 1 distinct positions. Exact
    recovery needs e <= n - k, checked when ``k`` is given. The tables
    come from the device product tree; then two single transforms through
    ``ntt_auto``: h = iNTT(c * l(w)) (K5 -> K3) and the forward transform
    of m*h_m with the Forney multiply and the merge (K5 -> K7-sel)."""
    cw = as_tensor(codeword, device)
    n = cw.shape[0]
    idx = _positions(erased_idx, cw.device)
    e = int(idx.shape[0])
    _check_erasures(e, n)
    _check_recoverable(e, n, k)
    mask, l_prep, lp_inv = _decode_tables_device(idx, n, field)
    h_coeffs = ntt_auto(cw, field, inverse=True, pre_vec=l_prep)
    return ntt_auto(h_coeffs, field,
                    pre_vec=_xderiv_on(field.name, n, str(cw.device)),
                    post_vec=lp_inv, sel_mask=mask, sel_orig=cw)


# ---------------------------------------------------------------------------
# Unknown-position error correction: locate up to (n-k)/2 silently
# corrupted rows algebraically, then erase-and-recover them.
#
# c'_j = f(w^j) + e_j with errors at unknown positions E, |E| = t.
# iNTT(c')[m] = f_m + n^-1 sum_{j in E} e_j w^(-jm), and f_m = 0 for m >= k,
# so S_r := iNTT(c')[k+r] = sum_{j in E} E_j X_j^r with X_j = w^-j: power-sum
# syndromes. Berlekamp-Massey finds the minimal LFSR Lambda(x) =
# prod_j (1 - X_j x) from 2t <= n-k syndromes; its roots are w^j, so one
# forward transform of Lambda evaluates it at every w^j and its zeros are
# the error positions. Needs all n rows present and t <= (n-k)/2.
# ---------------------------------------------------------------------------

def _berlekamp_massey(s: np.ndarray, p: int) -> np.ndarray:
    """Minimal LFSR connection polynomial Lambda as uint64 [t+1] values
    mod p (Lambda[0] = 1) with sum_{i=0..t} Lambda[i] * s[r-i] = 0 for
    all r >= t. Vectorized numpy u64 (the reference's): the discrepancy
    is one reduced dot product, the update one vector multiply-subtract
    (every product < p^2 < 2^64)."""
    s = np.asarray(s, dtype=np.uint64)
    nw = int(s.shape[0])
    p64 = np.uint64(p)
    c = np.zeros(2 * nw + 2, dtype=np.uint64)  # room for m + len(b)
    c[0] = 1
    lc = 1                             # written extent of c
    b = np.ones(1, dtype=np.uint64)    # previous connection poly
    L, m, bb = 0, 1, 1                 # LFSR len, gap, last discrepancy
    for r in range(nw):
        # deg(C) <= L (BM invariant), so the window is L+1 terms
        d = int((c[:L + 1] * s[r - L: r + 1][::-1] % p64).sum() % p64)
        if d == 0:
            m += 1
            continue
        swap = 2 * L <= r
        t0 = c[:lc].copy() if swap else None
        coef = np.uint64(d * pow(bb, p - 2, p) % p)
        upd = b * coef % p64
        lb = b.shape[0]
        c[m:m + lb] = (c[m:m + lb] + p64 - upd) % p64
        lc = max(lc, m + lb)
        if swap:
            L, b, bb, m = r + 1 - L, t0, d, 1
        else:
            m += 1
    return c[: L + 1].copy()


# Elements of one row block of _lane_combo: its int64 temporaries stay
# ~128 MiB each whatever the lane count.
_COMBO_BLOCK = 1 << 24


def _lane_combo(field: FieldSpec, x: torch.Tensor, combo_prep: torch.Tensor):
    """Linear combination of the lane axis of u32 [m, L] -> u32 [m] with
    prepared coefficients [L]: the elementwise multiply, then one int64 sum
    over the lanes and one reduction. Each term is below 2^32, so the sum
    is exact below 2^31 lanes and its residue is the reference's log-depth
    modular sum. Row blocks bound the temporaries."""
    m, lanes = x.shape
    c = gf.widen(combo_prep)[None, :]
    out = torch.empty(m, dtype=torch.int64, device=x.device)
    step = max(1, _COMBO_BLOCK // max(1, lanes))
    for r0 in range(0, m, step):
        y = mul_prepared(field, gf.widen(x[r0:r0 + step]), c)
        out[r0:r0 + step] = y.sum(dim=1) % field.p
    return gf.narrow(out)


def _rand_combo(field: FieldSpec, lanes: int, rng: np.random.Generator,
                device=None) -> torch.Tensor:
    """Prepared random nonzero lane coefficients for :func:`_lane_combo`,
    on ``device`` (default: the card). ``rng`` is seeded from OS entropy
    by default: an adversary who forges the corruption can read a fixed
    seed and craft corruption whose lane combination vanishes."""
    c = rng.integers(1, field.p, size=lanes, dtype=np.uint64).astype(
        np.uint32)
    return as_tensor(np.asarray(prepare_consts(field, c)), device)


def _syndrome_combos(cw2: torch.Tensor, pre, c1, c2, field: FieldSpec,
                     base: int):
    """[n, L] codeword -> two independently combined syndrome sequences
    [n-base] (u32): one inverse transform (with ``pre``, the erasure
    locator's evaluations, fused into pass A), then the two lane
    combinations of its rows from ``base`` on."""
    syn = ntt_auto(cw2, field, inverse=True, pre_vec=pre)[base:]
    return _lane_combo(field, syn, c1), _lane_combo(field, syn, c2)


def locate_errors(codeword, k: int, field: FieldSpec, erased=None,
                  entropy=None, retries: int = 2, device=None):
    """Positions of corrupted rows at unknown positions (bit rot that also
    forged the CRC tags): a sorted numpy int64 array, empty if the
    codeword is consistent, or None if the corruption is not locatable
    (too many bad rows, or an adversarial pattern).

    ``erased`` (optional) lists KNOWN-erased rows, the errors-and-erasures
    form: the codeword is weighted by the erasure locator's evaluations
    (zero at erased rows), so coefficients k+e.. are syndromes of the
    weighted unknown errors and up to t <= (n-k-e)/2 more rows are found.

    Syndromes come from random linear combinations over ALL lanes (one
    corrupt word in one lane is enough to find a row; two independent
    combos are checked), Berlekamp-Massey runs on the host and the
    locator's roots come from one forward transform over all n points.
    The combos are drawn from OS entropy unless ``entropy`` (any numpy
    SeedSequence entropy) pins them; an unlocatable result is retried up
    to ``retries`` times with fresh combos. The transforms run on the
    codeword's device (a numpy codeword goes to ``device``, default: the
    card)."""
    cw = as_tensor(codeword, device)
    n = cw.shape[0]
    cw2 = cw.reshape(n, -1)
    base, pre = k, None
    if erased is not None and len(erased):
        erased = _positions(erased, "cpu").numpy()
        base = k + int(erased.shape[0])
        if base >= n:
            return None
        l_eval, _ = locator_host(erased, n, field)
        pre = as_tensor(np.asarray(prepare_consts(field, l_eval)), cw.device)
    rng = np.random.default_rng(entropy)
    for _attempt in range(retries + 1):
        c1 = _rand_combo(field, cw2.shape[1], rng, cw.device)
        c2 = _rand_combo(field, cw2.shape[1], rng, cw.device)
        j1, j2 = _syndrome_combos(cw2, pre, c1, c2, field, base)
        pos = _bm_locate(to_numpy_u32(j1).astype(np.uint64),
                         to_numpy_u32(j2).astype(np.uint64), n, base, field,
                         cw.device)
        if pos is not None:
            return pos
    return None


def _bm_locate(s1, s2, n: int, base: int, field: FieldSpec, device=None):
    """Shared BM-locator core over two independently combined syndrome
    sequences (numpy u64). Returns positions / empty / None as
    :func:`locate_errors` does. The syndrome window grows along
    ``_BM_LADDER`` (a window of w locates up to w/2 errors); a locator is
    accepted only when BOTH full sequences satisfy its recurrence and it
    has exactly t roots among the w^j (one forward transform on
    ``device``)."""
    if not s1.any() and not s2.any():
        return np.empty(0, dtype=np.int64)
    p = np.uint64(field.p)
    s, other = (s1, s2) if s1.any() else (s2, s1)
    for window in _BM_LADDER:
        w = min(window, n - base)
        last = w == n - base or window == _BM_MAX
        lam_u = _berlekamp_massey(s[:w], field.p)
        t = int(lam_u.shape[0]) - 1
        if (t == 0 or 2 * t > w or not _lfsr_holds(lam_u, s, p)
                or not _lfsr_holds(lam_u, other, p)):
            if last:
                return None
            continue
        pad = np.zeros(n, dtype=np.uint32)
        pad[: t + 1] = lam_u.astype(np.uint32)
        evals = to_numpy_u32(_eval_poly(pad[:, None], field, device))[:, 0]
        pos = np.nonzero(evals == 0)[0]
        if pos.size == t:
            return np.sort(pos)
        if last:
            return None
    return None


# Syndrome-window cap: locates up to _BM_MAX/2 = 16,384 corrupt rows (the
# reference's designed capacity; mass corruption is the CRC tags' job).
# The ladder keeps plausible corruption counts fast.
_BM_MAX = 32768
_BM_LADDER = (64, 1024, 16384, _BM_MAX)


def _eval_poly(pad: np.ndarray, field: FieldSpec, device=None):
    """Evaluations at every w^j of the polynomial whose coefficients are
    the [n, 1] ``pad``: one forward transform on ``device``."""
    return ntt_auto(pad, field, device=device)


def _lfsr_holds(lam_u: np.ndarray, s: np.ndarray, p: np.uint64) -> bool:
    """Vectorized check that sum_i lam[i] * s[r-i] == 0 (mod p) for every
    r >= t across the FULL syndrome sequence."""
    t = lam_u.shape[0] - 1
    if s.shape[0] <= t:
        return True
    acc = np.zeros(s.shape[0] - t, dtype=np.uint64)
    for i in range(t + 1):
        acc = (acc + lam_u[i] * s[t - i: s.shape[0] - i] % p) % p
    return not acc.any()


def correct_errors(codeword, k: int, field: FieldSpec, erased=None,
                   entropy=None, device=None):
    """Correct silently corrupted rows at UNKNOWN positions: up to (n-k)/2
    of them or, with ``erased`` listing known-lost rows, the full
    errors-and-erasures capacity e + 2t <= n-k (the erased rows are
    recovered too). ``entropy`` pins the combos (:func:`locate_errors`).

    Returns (corrected [n, ...] u32 tensor on the codeword's device,
    positions): positions is the sorted numpy int64 array of the
    UNKNOWN-position rows that were fixed (empty if the input was
    consistent apart from the declared erasures). Raises ValueError when
    the corruption cannot be located, when nothing was located but the
    codeword is inconsistent, or when the corrected codeword fails the
    consistency check."""
    cw = as_tensor(codeword, device)
    pos = locate_errors(cw, k, field, erased=erased, entropy=entropy)
    if pos is None:
        raise ValueError(
            "corruption not locatable (beyond the e + 2t <= n-k "
            "errors-and-erasures capacity, or degenerate pattern)")
    e_arr = (_positions(erased, "cpu").numpy()
             if erased is not None and len(erased) else
             np.empty(0, dtype=np.int64))
    all_bad = np.union1d(e_arr, pos)
    if all_bad.size == 0:
        # nothing located: the codeword must BE consistent (a combo fluke
        # that annihilates every corrupt row must fail loudly)
        if not bool(verify_codeword(cw, field, k)):
            raise ValueError(
                "codeword inconsistent but no corrupt rows located "
                "(syndrome-combination fluke or degenerate pattern)")
        return cw, pos
    fixed = decode_host_prepared(cw, all_bad, field, k=k)
    if not bool(verify_codeword(fixed, field, k)):
        raise ValueError("post-correction consistency check failed")
    return fixed, pos


# ---------------------------------------------------------------------------
# Block-level (wire format) decode.
# ---------------------------------------------------------------------------

def survivors_to_codeword(survivors: dict, n: int, k: int, field: FieldSpec,
                          block_bytes: int = packing.BLOCK_BYTES):
    """Parse {position: wire bytes} into a zero-filled [n, lanes] numpy
    u32 codeword plus a presence mask, checking every blob's size against
    its kind (data or parity). Packing runs on the host: the native
    library at 4 KB blocks when it is loaded, the plain packing
    otherwise."""
    from . import host

    lanes = packing.field_lanes(field, block_bytes)
    dpos = set(data_positions(n, k).tolist())
    want_parity = packing.parity_bytes(field, block_bytes)
    cw = np.zeros((n, lanes), dtype=np.uint32)
    present = np.zeros(n, dtype=bool)
    d_items, p_items = [], []
    for pos, blob in survivors.items():
        if not 0 <= pos < n:
            # a negative key would wrap under numpy indexing and overwrite
            # a real survivor row
            raise ValueError(f"survivor position {pos} outside [0, {n})")
        raw = np.frombuffer(bytes(blob), dtype=np.uint8)
        kind, want, items = (("data", block_bytes, d_items) if pos in dpos
                             else ("parity", want_parity, p_items))
        if raw.size != want:
            raise ValueError(f"bad {kind} block @ {pos}: {raw.size} bytes, "
                             f"expected {want}")
        items.append((pos, raw))
        present[pos] = True
    native = host.available() and block_bytes == packing.BLOCK_BYTES
    for items, conv, conv_native in (
            (d_items, packing.pack_data, host.pack_data),
            (p_items, packing.deserialize_parity, host.deserialize_parity)):
        if items:
            arr = np.stack([r for _, r in items])
            cw[[p for p, _ in items]] = (
                conv_native(arr, field) if native else
                conv(torch.from_numpy(arr), field).view(
                    torch.int32).numpy().view(np.uint32))
    return cw, present


def decode_blocks(survivors: dict, n: int, k: int, field: FieldSpec,
                  block_bytes: int = packing.BLOCK_BYTES,
                  check: bool = False, device=None) -> torch.Tensor:
    """Recover all k data blocks from any >= k surviving codeword blocks.

    ``survivors`` maps codeword position -> bytes: data positions hold
    raw ``block_bytes``-byte blocks, parity positions hold
    ``parity_bytes(field, block_bytes)`` wire parity. Returns the [k,
    block_bytes] uint8 data blocks on ``device`` (default: the card).
    The decode runs on the host-known erasure positions
    (:func:`decode_host_prepared`); the kernels mask the ragged lane
    edge, so the wire's lane count needs no padding.

    ``check=True`` verifies the decoded codeword's consistency (one more
    transform). A failure means some SURVIVOR was silently corrupted:
    where the remaining redundancy allows (e + 2t <= n-k) the corrupt
    survivors are located and corrected (:func:`correct_errors`),
    otherwise ValueError. Without it such corruption reaches the output
    silently (the CRC tags are the first line of defence)."""
    if len(survivors) < k:
        raise ValueError(f"unrecoverable: {len(survivors)} survivors < k={k}")
    cw, present = survivors_to_codeword(survivors, n, k, field, block_bytes)
    erased = np.nonzero(~present)[0]
    full = as_tensor(cw, device)
    if erased.size:
        fixed = decode_host_prepared(full, erased, field, k=k)
        if check and not bool(verify_codeword(fixed, field, k)):
            fixed, _ = correct_errors(full, k, field, erased=erased)
        full = fixed
    elif check and not bool(verify_codeword(full, field, k)):
        full, _ = correct_errors(full, k, field)
    rows = full.view(torch.int32)[torch.from_numpy(
        data_positions(n, k)).to(full.device)]
    return packing.unpack_data(rows.view(torch.uint32), field)


def decode_data_from_parity(parity, field: FieldSpec, n: int,
                            device=None) -> torch.Tensor:
    """All-data-erased rate-1/2 decode in the field domain: [k, L] parity
    rows (``encode_parity`` order, the odd codeword positions) -> [k, L]
    data rows. parity[i] = f(w_n w_k^i), so iNTT_k(parity)[m] = f_m w_n^m
    and data = NTT_k(that x w_n^-m): the encode pair with the inverse
    coset seed (K1 -> K2 -> K3; K1 -> K3 then K4 -> K3 with the pair
    switch off), no locator tables."""
    par = as_tensor(parity, device)
    k = par.shape[0]
    if n != 2 * k:
        raise ValueError(f"parity-only decode is the rate-1/2 path, got "
                         f"n={n} for {k} parity rows")
    w_inv = field.inv_host(field.root_of_order(n))
    x = par.reshape(k, -1)
    if ntt_mfa._pair_supported(k):
        out = ntt_mfa.ntt_coset_pair(x, field, w_inv)
    else:
        out = ntt_auto(ntt_auto(x, field, inverse=True), field,
                       pre_seed=w_inv)
    return out.reshape(par.shape)


def decode_wire_parts(parity_pairs, n: int, k: int, field: FieldSpec,
                      device=None) -> torch.Tensor:
    """The all-data-erased wire decode in u32 byte images: [n-k,
    parity_bytes/4] u32 LE view of the wire parity in, [k, block_bytes/4]
    u32 LE view of the data blocks out (rate 1/2, any lane count).

    GF32: the parity lanes ARE field elements; decode the [k, W + W/16]
    rows and fold each escape bit back in (word = stored + bit * p).
    GF16: split each u32 into its lo/hi u16 words plus escape bits
    (0x10000 is stored as 0 with a bitmap bit), decode lo || hi along the
    lane axis, and join the halves again."""
    pairs = as_tensor(parity_pairs, device)
    m = pairs.shape[0]
    if n != 2 * k or m != k:
        raise ValueError(f"wire parts decode is rate 1/2 (n = 2k, k parity "
                         f"rows), got n={n} k={k} rows={m}")
    if field.use_mont:
        rows = gf.widen(decode_data_from_parity(pairs, field, n))
        wd = packing._words_from_lanes(pairs.shape[1])
        esc = packing._unpack_bits(rows[:, wd:], 16, wd)
        return gf.narrow(rows[:, :wd] + esc * field.p)
    wu = pairs.shape[1]                         # parity_bytes / 4
    w = packing._words_from_lanes(2 * wu)       # stored wire words
    if w % 2:
        raise ValueError("odd stored-word counts need the bytes API")
    wp = w // 2                                 # u32 pairs of stored words
    pw = gf.widen(pairs)
    st, bmp = pw[:, :wp], pw[:, wp:]
    # bitmap u16 word q//8 holds the escape bits of pair q: bit 2(q%8)
    # for its lo word, bit 2(q%8)+1 for its hi word
    bm = torch.stack([bmp & 0xFFFF, bmp >> 16], dim=-1).reshape(m, -1)
    q = torch.arange(wp, device=pw.device)
    bmx = bm[:, q // 8]
    sh = 2 * (q % 8)
    lo = (st & 0xFFFF) + ((bmx >> sh) & 1) * 0x10000
    hi = (st >> 16) + ((bmx >> (sh + 1)) & 1) * 0x10000
    out = gf.widen(decode_data_from_parity(
        gf.narrow(torch.cat([lo, hi], dim=1)), field, n))
    return gf.narrow(out[:, :wp] | (out[:, wp:] << 16))


def decode_wire_parity(parity_wire, n: int, k: int, field: FieldSpec,
                       device=None) -> torch.Tensor:
    """The all-data-erased wire decode on bytes: [n-k, parity_bytes]
    uint8 wire parity in, [k, block_bytes] uint8 data blocks out
    (bitcasts around :func:`decode_wire_parts`)."""
    raw = as_tensor(parity_wire, device)
    if raw.shape[-1] % 4:
        raise ValueError("standard block sizes only (parity_bytes % 4 == 0)")
    pairs = packing._bytes_to_u32(raw, 4)
    return packing._u32_to_bytes(decode_wire_parts(pairs, n, k, field), 4)
