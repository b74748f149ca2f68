"""Reed-Solomon erasure encode over GF(p) via NTTs: the port's
counterpart of ``rs.py`` (encode side).

Scheme (as the reference): k data blocks are the evaluations of a
degree-<k polynomial f on the order-k subgroup, data[i] = f(w_k^i), per
lane; the codeword is codeword[j] = f(w_n^j), j in [0, n). It is
systematic: codeword[c*i] == data[i] with c = n/k. Parity uses the coset
trick: codeword[c*i + r] = NTT_k(coeffs[m] * w_n^(r*m))[i] with
coeffs = iNTT_k(data).

Entry points take u32 tensors or numpy arrays (``device``: see
:mod:`interop`) with the transform along axis 0 and lanes trailing. On a
CUDA tensor the transforms run on the Hopper kernels: rate 1/2 as the
three-pass pair (K1 -> K2 -> K3), other rates (and rate 1/2 with the pair
switch ``ntt_mfa.PAIR_ENABLED`` off) as iNTT (K1 -> K3) and one coset NTT
(K4 -> K3) per parity coset; the GF16 wire encode as the wire pair (K8 ->
K9 -> K10). On a CPU tensor the same structure runs on the
kernels' plain versions. Beside the encode: partial-stripe parity
updates, codeword verification, stripe batches and the out-of-core
lane-chunk stream.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import gf, packing
from .fields import FieldSpec, FIELDS, GF16
from .interop import as_tensor, resolve_device
from .kernels import ntt_mfa
from .ntt import (mul_prepared, ntt_auto, powers_host, powers_outer_host,
                  prepare_consts)
from .utils import profiling


def _check_kn(k: int, n: int) -> None:
    if k & (k - 1) or k < 1:
        raise ValueError(f"k must be a power of two, got {k}")
    if n & (n - 1) or n < 1:
        raise ValueError(f"n must be a power of two, got {n}")
    if n <= k:
        raise ValueError(f"need n > k, got n={n} k={k}")


def _cat_u32(parts, dim: int) -> torch.Tensor:
    return torch.cat([p.view(torch.int32) for p in parts], dim=dim).view(
        torch.uint32)


@functools.lru_cache(maxsize=None)
def _coset_twiddles(field_name: str, n: int, k: int):
    """Prepared [c-1, k] table t[r-1, m] = w_n^(r*m) for cosets
    r = 1..c-1."""
    field = FIELDS[field_name]
    c = n // k
    w = field.root_of_order(n)
    bases = powers_host(field, w, c)[1:]
    rows = powers_outer_host(field, bases, k)
    return np.asarray(prepare_consts(field, rows))


@functools.lru_cache(maxsize=None)
def _coset_twiddles_scaled(field_name: str, n: int, k: int):
    """Prepared [c-1, k] table w_n^(r*m) * k^-1: the iNTT's scale folded
    into the coset multiply, for callers that run the iNTT unscaled (the
    sharded encode, ``parallel.encode_parity_sharded``). Same residues as
    scaling, then multiplying."""
    field = FIELDS[field_name]
    c = n // k
    w = field.root_of_order(n)
    bases = powers_host(field, w, c)[1:]
    rows = powers_outer_host(field, bases, k).astype(np.uint64)
    rows = rows * np.uint64(field.inv_host(k)) % np.uint64(field.p)
    return np.asarray(prepare_consts(field, rows.astype(np.uint32)))


def data_positions(n: int, k: int) -> np.ndarray:
    """Codeword indices holding the (unchanged) data blocks."""
    return np.arange(k) * (n // k)


def parity_positions(n: int, k: int) -> np.ndarray:
    """Codeword indices of parity blocks, in ``encode_parity`` row order."""
    c = n // k
    return np.arange(n).reshape(k, c)[:, 1:].reshape(-1)


# ---------------------------------------------------------------------------
# Field-domain codec core.
# ---------------------------------------------------------------------------

def encode_parity(data, field: FieldSpec, n: int | None = None,
                  lane_chunks: int = 1, device=None) -> torch.Tensor:
    """Parity rows only, [n-k, ...], from u32 data [k, ...].

    Row (i*(c-1) + (r-1)) is codeword position i*c + r (the order of
    ``encode(...)[parity_positions(n, k)]``). ``lane_chunks > 1`` encodes
    the independent lanes of a 2-D input in that many sequential chunks
    (bounds peak device memory); bit-identical to one call. Runs inside
    the span ``fecc.rs.encode_parity`` (one a chunk besides)."""
    with profiling.scope("fecc.rs.encode_parity"):
        data = as_tensor(data, device)
        k = data.shape[0]
        n = 2 * k if n is None else n
        _check_kn(k, n)
        if lane_chunks > 1:
            if data.dim() != 2 or data.shape[1] % lane_chunks:
                raise ValueError(f"lane_chunks={lane_chunks} must divide the "
                                 f"lanes of a 2-D input, got "
                                 f"{tuple(data.shape)}")
            lc = data.shape[1] // lane_chunks
            return _cat_u32([encode_parity(data[:, i * lc:(i + 1) * lc],
                                           field, n)
                             for i in range(lane_chunks)], dim=1)
        c = n // k
        rest = tuple(data.shape[1:])
        x = data.contiguous().reshape(k, -1)
        w_n = field.root_of_order(n)
        if c == 2 and ntt_mfa._pair_supported(k):
            # rate 1/2: the whole iNTT -> coset NTT pair in three passes
            return ntt_mfa.ntt_coset_pair(x, field, w_n).reshape((k,) + rest)
        coeffs = ntt_auto(x, field, inverse=True)
        cosets = [ntt_auto(coeffs, field, pre_seed=field.pow_host(w_n, r))
                  for r in range(1, c)]
        stacked = torch.stack([t.view(torch.int32) for t in cosets], dim=1)
        return stacked.view(torch.uint32).reshape((n - k,) + rest)


def encode(data, field: FieldSpec, n: int | None = None,
           device=None) -> torch.Tensor:
    """Full codeword [n, ...] from data [k, ...]: the data interleaved
    with the coset parity rows (systematic: codeword[c*i] == data[i])."""
    data = as_tensor(data, device)
    k = data.shape[0]
    n = 2 * k if n is None else n
    _check_kn(k, n)
    c = n // k
    parity = encode_parity(data, field, n)
    rows = _cat_u32([data[:, None],
                     parity.reshape((k, c - 1) + tuple(data.shape[1:]))],
                    dim=1)
    return rows.reshape((n,) + tuple(data.shape[1:]))


def encode_padded(data, field: FieldSpec, n: int | None = None,
                  device=None) -> torch.Tensor:
    """Full codeword via the literal iNTT_k -> zero-pad -> NTT_n pipeline
    (the reference RS.cpp structure); an independent cross-check of
    :func:`encode`."""
    data = as_tensor(data, device)
    k = data.shape[0]
    n = 2 * k if n is None else n
    _check_kn(k, n)
    coeffs = ntt_auto(data, field, inverse=True)
    pad = torch.zeros((n - k,) + tuple(data.shape[1:]), dtype=torch.uint32,
                      device=data.device)
    return ntt_auto(_cat_u32([coeffs, pad], dim=0), field)


# ---------------------------------------------------------------------------
# Partial-stripe updates, verification, batches.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _update_point_tables(field_name: str, n: int, k: int):
    """(y, y^k) u64 arrays at the parity positions, the same for every
    data-block index (cached per (field, n, k))."""
    field = FIELDS[field_name]
    w_n = field.root_of_order(n)
    pos = parity_positions(n, k).astype(np.uint64)
    wn_pows = powers_host(field, w_n, n).astype(np.uint64)
    wnk_pows = powers_host(field, field.pow_host(w_n, k),
                           n).astype(np.uint64)
    return wn_pows[pos], wnk_pows[pos]


@functools.lru_cache(maxsize=None)
def _update_row_consts(field_name: str, n: int, k: int, i: int):
    """Prepared [n-k] vector v with v[r] = L_i(y_r): the parity response
    to a unit change of data block i (rows in encode_parity order). For
    data on the order-k subgroup x_m = w_k^m the node polynomial is
    x^k - 1, so L_i(y) = (y^k - 1) x_i / (k (y - x_i)); one batched
    inversion on the host."""
    from .decode import _inv_host_vec

    field = FIELDS[field_name]
    p = np.uint64(field.p)
    x_i = np.uint64(field.pow_host(field.root_of_order(k), i))
    y, yk = _update_point_tables(field_name, n, k)
    num = (yk + p - np.uint64(1)) % p * x_i % p
    den = np.uint64(k % field.p) * ((y + p - x_i) % p) % p
    vals = num * _inv_host_vec(den.astype(np.uint32), field) % p
    return np.asarray(prepare_consts(field, vals.astype(np.uint32)))


def update_parity(parity, i: int, old_block, new_block, field: FieldSpec,
                  n: int | None = None, device=None) -> torch.Tensor:
    """Parity after data block ``i`` changes from ``old_block`` to
    ``new_block`` ([L] or [1, L] field rows): parity + L_i(y) * (new -
    old), an O((n-k) * L) update instead of a re-encode (the RAID-style
    partial-stripe write). ``parity`` is [n-k, L] in encode_parity row
    order. Bit-exact equal to re-encoding the modified data."""
    par = as_tensor(parity, device)
    old = as_tensor(old_block, par.device).reshape(1, -1)
    new = as_tensor(new_block, par.device).reshape(1, -1)
    return update_parity_multi(par, (i,), old, new, field, n)


def update_parity_multi(parity, idxs, old_blocks, new_blocks,
                        field: FieldSpec, n: int | None = None,
                        device=None) -> torch.Tensor:
    """:func:`update_parity` for several data blocks at once: parity +
    sum_j L_idxs[j](y) * (new[j] - old[j]); ``old_blocks``/``new_blocks``
    are [s, L]. Raises ValueError where the reference asserts."""
    par = as_tensor(parity, device)
    m = par.shape[0]
    n = 2 * m if n is None else n
    k = n - m
    _check_kn(k, n)
    idxs = tuple(int(i) for i in idxs)
    old = as_tensor(old_blocks, par.device)
    new = as_tensor(new_blocks, par.device)
    if not len(idxs) == old.shape[0] == new.shape[0]:
        raise ValueError(f"{len(idxs)} indices for {old.shape[0]} old and "
                         f"{new.shape[0]} new blocks")
    if not all(0 <= i < k for i in idxs):
        raise ValueError(f"data-block indices must lie in [0, {k}), got "
                         f"{idxs}")
    if not idxs:
        return par
    delta = gf.sub(field, new, old)
    vs = np.stack([_update_row_consts(field.name, n, k, i) for i in idxs])
    return apply_parity_update(par, vs, delta, field)


# Elements of one row block of apply_parity_update: its int64 temporaries
# stay ~128 MiB each whatever the parity's size.
_UPDATE_BLOCK = 1 << 24


def apply_parity_update(parity_rows, vs, delta, field: FieldSpec,
                        device=None) -> torch.Tensor:
    """parity_rows[r] + sum_j vs[j, r] * delta[j]: the core of
    :func:`update_parity_multi`, row-sliceable. ``vs`` is [s, B] prepared
    L_i(y_r) constants (``_update_row_consts`` rows, sliced to these
    parity rows), ``delta`` the [s, L] field-domain block deltas. A
    loop over the span (the reference's ``fori_loop``) in int64
    carriers, in row blocks that bound the temporaries."""
    par = as_tensor(parity_rows, device)
    dev = par.device
    v = gf.widen(as_tensor(vs, dev))
    d = gf.widen(as_tensor(delta, dev))
    rows, lanes = par.shape[0], par[0].numel()
    out = torch.empty_like(par).view(torch.int32).reshape(rows, lanes)
    step = max(1, _UPDATE_BLOCK // max(1, lanes))
    for r0 in range(0, rows, step):
        acc = gf.widen(par[r0:r0 + step].reshape(-1, lanes))
        for j in range(d.shape[0]):
            acc = gf.add(field, acc, mul_prepared(
                field, d[j].reshape(1, lanes), v[j, r0:r0 + step, None]))
        out[r0:r0 + step] = gf.narrow(acc).view(torch.int32)
    return out.view(torch.uint32).reshape(par.shape)


def verify_codeword(codeword, field: FieldSpec, k: int,
                    device=None) -> torch.Tensor:
    """True (a 0-d bool tensor on the codeword's device) iff every lane
    is a codeword: the evaluations of a degree-<k polynomial, i.e.
    iNTT_n(cw)[k:] == 0. One unscaled inverse transform (K1 -> K3; the
    scale cannot turn nonzero into zero)."""
    cw = as_tensor(codeword, device)
    coeffs = ntt_auto(cw, field, inverse=True, scale=False)
    return torch.all(coeffs[k:].view(torch.int32) == 0)


def encode_parity_batch(data, field: FieldSpec, n: int | None = None,
                        device=None) -> torch.Tensor:
    """Parity of S independent stripes at once: [S, k, L] -> [S, n-k, L].
    Lanes are independent codewords, so the stripe axis moves into the
    lanes and one encode (one launch per pass) serves the batch."""
    d = as_tensor(data, device)
    s, k, lanes = d.shape
    n = 2 * k if n is None else n
    flat = d.view(torch.int32).movedim(0, 1).reshape(k, s * lanes)
    par = encode_parity(flat.view(torch.uint32), field, n)
    return par.view(torch.int32).reshape(n - k, s, lanes).movedim(
        1, 0).contiguous().view(torch.uint32)


# ---------------------------------------------------------------------------
# Out-of-core streaming over lane chunks.
# ---------------------------------------------------------------------------

def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host u32 slice as a u32 tensor on ``device``. For a card the
    slice is copied once, straight into a pinned buffer, which goes up
    asynchronously on the current stream."""
    if device.type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(
            host, np.uint32).view(np.int32)).view(torch.uint32)
    buf = torch.empty(host.shape, dtype=torch.int32, pin_memory=True)
    buf.numpy().view(np.uint32)[...] = host
    return buf.to(device, non_blocking=True).view(torch.uint32)


def stream_lane_chunks(lanes: int, chunk_lanes: int, dispatch,
                       out: np.ndarray, device=None) -> np.ndarray:
    """Depth-2 host <-> device pipeline over lane slices (shared by the
    streaming encode and decode). ``dispatch(offset)`` returns the u32
    result for columns [offset, offset + chunk_lanes); results land in
    the host array ``out``. At most two results are outstanding: while
    chunk i computes, chunk i-1 downloads and i+1 uploads. On a card
    (``device``) the chunks run on a side stream (which first waits for
    the current one, where the caller made any tables), each result
    downloads into a pinned buffer, and an event per chunk tells the host
    when to copy it out."""
    dev = torch.device("cpu" if device is None else device)
    pending = []

    def drain(item):
        off, host, done = item
        if done is not None:
            done.synchronize()
        out[:, off:off + chunk_lanes] = host.numpy().view(np.uint32)

    def run():
        for off in range(0, lanes, chunk_lanes):
            if len(pending) >= 2:
                drain(pending.pop(0))
            y = dispatch(off).view(torch.int32)
            if dev.type != "cuda":
                pending.append((off, y, None))
                continue
            host = torch.empty(y.shape, dtype=torch.int32, pin_memory=True)
            host.copy_(y, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            pending.append((off, host, done))
        for item in pending:
            drain(item)
        return out

    if dev.type != "cuda":
        return run()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        return run()


def _chunk(lanes: int, chunk_lanes: int) -> int:
    chunk = min(chunk_lanes, lanes)
    if lanes % chunk:
        raise ValueError(f"chunk_lanes {chunk_lanes} must divide L={lanes} "
                         f"(or exceed it)")
    return chunk


def encode_parity_stream(data: np.ndarray, field: FieldSpec,
                         n: int | None = None, chunk_lanes: int = 1024,
                         out: np.ndarray | None = None,
                         device=None) -> np.ndarray:
    """Out-of-core encode for data larger than device memory: the host
    [k, L] u32 array (numpy or np.memmap) streams through ``device``
    (default: the card) in ``chunk_lanes``-wide slices with the depth-2
    pipeline of :func:`stream_lane_chunks`. Returns (or fills ``out``
    with) the [n-k, L] parity as host numpy, bit-identical to one
    :func:`encode_parity` call."""
    k, lanes = data.shape
    n = 2 * k if n is None else n
    _check_kn(k, n)
    chunk = _chunk(lanes, chunk_lanes)
    dev = resolve_device(device)
    if out is None:
        out = np.empty((n - k, lanes), dtype=np.uint32)

    def dispatch(off):
        return encode_parity(_upload(data[:, off:off + chunk], dev), field, n)

    return stream_lane_chunks(lanes, chunk, dispatch, out, dev)


# ---------------------------------------------------------------------------
# Block-level (wire format) API: raw data blocks in, parity bytes out.
# ---------------------------------------------------------------------------

def encode_blocks(raw_data, field: FieldSpec, n: int | None = None,
                  device=None) -> torch.Tensor:
    """[k, B] uint8 data blocks -> [n-k, parity_bytes(field, B)] uint8
    parity blocks. B is a multiple of 4 (GF32) or 2 (GF16); the default
    wire format uses 4096.

    GF16 at rate 1/2 with B % 4 == 0 and a shape the wire pair takes
    (``ntt_mfa._wire16_supported``) runs the fused wire pair
    (:func:`encode_blocks_gf16_parts`, K8 -> K9 -> K10: the unpack rides
    pass A1 and the serialization pass B2) unless the pair switch is off.
    Every other shape runs the generic pack -> encode_parity -> serialize
    composition. The choice
    is made from the shape alone; both give the same bytes. Runs inside
    the span ``fecc.rs.encode_blocks``; the generic composition's pack and
    serialization open ``fecc.packing.*`` spans of their own."""
    with profiling.scope("fecc.rs.encode_blocks"):
        raw = as_tensor(raw_data, device)
        k, block_bytes = raw.shape
        n2 = 2 * k if n is None else n
        if (not field.use_mont and n2 == 2 * k and block_bytes % 4 == 0
                and ntt_mfa._pair_supported(k)
                and ntt_mfa._wire16_supported(k, block_bytes // 4)):
            return _encode_blocks_gf16_fused(raw, n2)
        fields = packing.pack_data(raw, field)
        return packing.serialize_parity(encode_parity(fields, field, n2),
                                        field)


def _encode_blocks_gf16_fused(raw: torch.Tensor, n: int) -> torch.Tensor:
    """encode_blocks' GF16 wire-pair branch: bytes -> u32 pairs (a
    bitcast) -> the pair's parts -> wire bytes."""
    stored, bitmap = encode_blocks_gf16_parts(packing._bytes_to_u32(raw, 4),
                                              n)
    return wire_gf16_from_parts(stored, bitmap)


def encode_blocks_gf16_parts(raw_pairs, n: int | None = None, device=None):
    """GF16 wire-domain encode, parts form: [k, B/4] u32 LE byte image of
    the raw data blocks in (``raw.view(torch.uint32)``, or a numpy
    ``.view(np.uint32)``: free), (stored [k, B/4], bitmap [k, B/16]) u32
    out. stored's LE byte image is the serialized parity words; each
    bitmap word holds one 16-bit escape word (:func:`wire_gf16_from_parts`
    joins them into the wire bytes). Three passes, K8 -> K9 -> K10
    (``ntt_mfa.ntt_coset_pair_wire16``); rate 1/2 only (ValueError
    otherwise), k a power of two in [4, 2^15] and B % 32 == 0."""
    words = as_tensor(raw_pairs, device)
    k = words.shape[0]
    n = 2 * k if n is None else n
    if n != 2 * k:
        raise ValueError(f"the fused wire pair is the rate-1/2 path, got "
                         f"n={n} for k={k}")
    return ntt_mfa.ntt_coset_pair_wire16(words, GF16, GF16.root_of_order(n))


def wire_gf16_from_parts(stored, bitmap, device=None) -> torch.Tensor:
    """[m, parity_bytes] uint8 GF16 wire bytes from the parts of
    :func:`encode_blocks_gf16_parts`: stored's bytes, then each bitmap
    word's low 2 bytes (packing.serialize_parity's order). A uint8 tensor
    on the parts' device (numpy parts go to ``device``); any strides. Runs
    inside the span ``fecc.rs.wire_join``."""
    with profiling.scope("fecc.rs.wire_join"):
        st = as_tensor(stored, device).contiguous()
        bm = as_tensor(bitmap, st.device)
        return torch.cat([st.view(torch.uint8),
                          packing._u32_to_bytes(bm, 2)], dim=-1)


def encode_blocks_parts(raw_words, field: FieldSpec, n: int | None = None,
                        device=None) -> torch.Tensor:
    """GF32 wire-domain encode, parts form: [k, B/4] u32 LE byte image of
    the raw data blocks in, [n-k, parity_bytes/4] u32 LE byte image of the
    serialized parity out (GF32 wire parity IS its field lanes).
    Bit-identical to :func:`encode_blocks`' byte image."""
    if not field.use_mont:
        raise ValueError("encode_blocks_parts is the GF32 parts form")
    words = as_tensor(raw_words, device)
    k = words.shape[0]
    n2 = 2 * k if n is None else n
    return encode_parity(packing.pack_data_pairs(words, field), field, n2)
