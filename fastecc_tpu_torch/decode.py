"""Reed-Solomon erasure decoding in O(n log n): the port's counterpart of
``decode.py`` (erasure side).

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
from .interop import as_tensor, resolve_device
from .kernels import ntt_mfa
from .ntt import _log2, mul_prepared, ntt_auto, ntt_host, prepare_consts
from .rs import data_positions, parity_positions  # noqa: F401 (re-export)
from .rs import _chunk, _upload, stream_lane_chunks


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
    quotient. Bit-exact vs the device tables."""
    p = np.uint64(field.p)

    def mm(a, b):
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
            fa = ntt_host(np.concatenate([lhs, pad], axis=0), field)
            fb = ntt_host(np.concatenate([rhs, pad], axis=0), field)
            prod = ntt_host(mm(fa, fb), field, inverse=True)
            hi = (prod[d:].astype(np.uint64) + lhs + rhs) % p
            a = np.concatenate([prod[:d].astype(np.uint64), hi],
                               axis=0).astype(np.uint32)
            d, m = 2 * d, m // 2
        return a[:, 0]

    def mul_monic(a, b):
        d1, d2 = a.shape[0], b.shape[0]
        size = 1 << (d1 + d2 - 1).bit_length()
        fa = ntt_host(np.concatenate([a, np.zeros(size - d1, np.uint32)]),
                      field)
        fb = ntt_host(np.concatenate([b, np.zeros(size - d2, np.uint32)]),
                      field)
        conv = ntt_host(mm(fa, fb), field, inverse=True)[: d1 + d2].astype(
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
    l_eval = ntt_host(lpad, field)                        # l(w^j)
    # coefficients of x*l'(x) are m*l_m (no index shift)
    deriv = lc.astype(np.uint64) * (np.arange(e + 1, dtype=np.uint64)
                                    % p) % p
    dpad = np.concatenate([deriv.astype(np.uint32),
                           np.zeros(n - e - 1, np.uint32)])
    lp_inv = _inv_host_vec(ntt_host(dpad, field), field)  # 1/(w^j l'(w^j))
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
    from their own survivor copies)."""
    cw = as_tensor(codeword, device)
    n = cw.shape[0]
    x = cw.reshape(n, -1)
    dev = x.device
    mask, lp, ip = (as_tensor(t, dev) for t in (mask, l_eval_prep,
                                                 lp_inv_prep))
    out = ntt_mfa.ntt_pair(
        x, field, pre_vec1=lp, pre_vec2=_xderiv_on(field.name, n, str(dev)),
        post_vec=ip, sel_mask=mask if merge else None,
        sel_orig=x if merge else None)
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
# Block-level (wire format) decode.
# ---------------------------------------------------------------------------

def survivors_to_codeword(survivors: dict, n: int, k: int, field: FieldSpec,
                          block_bytes: int = packing.BLOCK_BYTES):
    """Parse {position: wire bytes} into a zero-filled [n, lanes] numpy
    u32 codeword plus a presence mask, checking every blob's size against
    its kind (data or parity). Packing runs on the host."""
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
    for items, conv in ((d_items, packing.pack_data),
                        (p_items, packing.deserialize_parity)):
        if items:
            arr = torch.from_numpy(np.stack([r for _, r in items]))
            cw[[p for p, _ in items]] = conv(arr, field).view(
                torch.int32).numpy().view(np.uint32)
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

    ``check=True`` (the consistency check and error correction of the
    reference) waits for ``correct_errors``, which is not ported yet: it
    raises ``NotImplementedError``."""
    if check:
        raise NotImplementedError(
            "decode_blocks(check=True) needs correct_errors, which is not "
            "yet ported")
    if len(survivors) < k:
        raise ValueError(f"unrecoverable: {len(survivors)} survivors < k={k}")
    cw, present = survivors_to_codeword(survivors, n, k, field, block_bytes)
    erased = np.nonzero(~present)[0]
    full = as_tensor(cw, device)
    if erased.size:
        full = decode_host_prepared(full, erased, field, k=k)
    rows = full.view(torch.int32)[torch.from_numpy(
        data_positions(n, k)).to(full.device)]
    return packing.unpack_data(rows.view(torch.uint32), field)


def decode_data_from_parity(parity, field: FieldSpec, n: int,
                            device=None) -> torch.Tensor:
    """All-data-erased rate-1/2 decode in the field domain: [k, L] parity
    rows (``encode_parity`` order, the odd codeword positions) -> [k, L]
    data rows. parity[i] = f(w_n w_k^i), so iNTT_k(parity)[m] = f_m w_n^m
    and data = NTT_k(that x w_n^-m): the encode pair with the inverse
    coset seed (K1 -> K2 -> K3), no locator tables."""
    par = as_tensor(parity, device)
    k = par.shape[0]
    if n != 2 * k:
        raise ValueError(f"parity-only decode is the rate-1/2 path, got "
                         f"n={n} for {k} parity rows")
    w_inv = field.inv_host(field.root_of_order(n))
    out = ntt_mfa.ntt_coset_pair(par.reshape(k, -1), field, w_inv)
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
