"""Plain reference of the GF32 wire format: raw byte blocks to field
lanes, parity lanes to bytes.

Plain PyTorch on int64 carriers, written from the format's description
and nothing of the program. A data block of B bytes is W = B/4
little-endian 32-bit words w_i. GF(0xFFF00001) holds no value at or above
p, so a word w_i >= p is stored as w_i - p (below 2^20, a field element)
and marked by an escape bit e_i = 1; every other word is stored as it is,
e_i = 0. The W escape bits follow the W stored words as ceil(W/16)
lanes of 16 bits: bit j of bitmap lane m is e_(16m + j), and the bits
past word W - 1 are zero. The encode treats every lane, the bitmap's
too, as a codeword of its own (``rs.Field("GF32").encode_parity``), and
a parity block is its lanes' values as little-endian 32-bit words, each
below p, so it is written with no escape: 4 (W + ceil(W/16)) bytes.
"""

from __future__ import annotations

import torch

P = 0xFFF00001      # GF32's prime, 2^32 - 2^20 + 1


def gf32_words(raw: torch.Tensor) -> torch.Tensor:
    """[k, B] uint8 data blocks -> [k, W + ceil(W/16)] int64 field lanes:
    the W stored words, then the escape bitmap's lanes."""
    k, b = raw.shape
    if b % 4:
        raise ValueError(f"GF32 blocks hold whole 32-bit words, got {b} B")
    r = raw.to(torch.int64).reshape(k, b // 4, 4)
    words = r[..., 0] | r[..., 1] << 8 | r[..., 2] << 16 | r[..., 3] << 24
    esc = (words >= P).to(torch.int64)
    stored = words - esc * P
    w = b // 4
    groups = -(-w // 16)
    esc = torch.nn.functional.pad(esc, (0, groups * 16 - w))
    shifts = torch.arange(16, dtype=torch.int64, device=raw.device)
    bitmap = (esc.reshape(k, groups, 16) << shifts).sum(dim=-1)
    return torch.cat([stored, bitmap], dim=1)


def gf32_wire(parity: torch.Tensor) -> torch.Tensor:
    """GF32 parity lanes [m, L] (int64 in [0, p)) -> their wire bytes
    [m, 4L] uint8: each lane's value as a little-endian 32-bit word."""
    m, lanes = parity.shape
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=parity.device)
    return ((parity[..., None] >> shifts) & 0xFF).reshape(
        m, 4 * lanes).to(torch.uint8)
