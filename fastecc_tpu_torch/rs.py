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
three-pass pair (K1 -> K2 -> K3), other rates as iNTT (K1 -> K3) and one
coset NTT (K4 -> K3) per parity coset. On a CPU tensor the same
structure runs on the kernels' plain versions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import packing
from .fields import FieldSpec, FIELDS
from .interop import as_tensor
from .kernels import ntt_mfa
from .ntt import ntt_auto, powers_host, powers_outer_host, prepare_consts


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
    (bounds peak device memory); bit-identical to one call."""
    data = as_tensor(data, device)
    k = data.shape[0]
    n = 2 * k if n is None else n
    _check_kn(k, n)
    if lane_chunks > 1:
        if data.dim() != 2 or data.shape[1] % lane_chunks:
            raise ValueError(f"lane_chunks={lane_chunks} must divide the "
                             f"lanes of a 2-D input, got {tuple(data.shape)}")
        lc = data.shape[1] // lane_chunks
        return _cat_u32([encode_parity(data[:, i * lc:(i + 1) * lc], field, n)
                         for i in range(lane_chunks)], dim=1)
    c = n // k
    rest = tuple(data.shape[1:])
    x = data.contiguous().reshape(k, -1)
    w_n = field.root_of_order(n)
    if c == 2:
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
# Block-level (wire format) API: raw data blocks in, parity bytes out.
# ---------------------------------------------------------------------------

def encode_blocks(raw_data, field: FieldSpec, n: int | None = None,
                  device=None) -> torch.Tensor:
    """[k, B] uint8 data blocks -> [n-k, parity_bytes(field, B)] uint8
    parity blocks (pack -> encode_parity -> serialize). B is a multiple
    of 4 (GF32) or 2 (GF16); the default wire format uses 4096.

    GF16 at rate 1/2 on the card is the reference's fused wire pair
    (kernels K8-K10), not yet ported: it raises. On the CPU it runs the
    generic composition, as the reference does off the TPU."""
    raw = as_tensor(raw_data, device)
    k = raw.shape[0]
    n2 = 2 * k if n is None else n
    if not field.use_mont and raw.is_cuda and n2 == 2 * k:
        raise NotImplementedError(
            "GF16 encode_blocks on CUDA runs through the fused wire "
            "kernels K8-K10 (_col_kernel_wire16, _seam_kernel_wire16, "
            "_row_kernel_wire16), which are not yet ported")
    fields = packing.pack_data(raw, field)
    return packing.serialize_parity(encode_parity(fields, field, n2), field)


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
