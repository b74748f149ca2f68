"""Raw bytes <-> field elements ("word escaping"): the port's counterpart
of ``packing.py``. Plain PyTorch ops, as the reference's were plain jnp;
the wire format is the reference's, byte for byte (the module docstring
of ``fastecc_tpu/packing.py`` is its prose spec).

GF32 data blocks (B bytes -> B/4 + ceil(B/4/16) lanes): W little-endian
u32 words; a word w >= p is stored as w - p with escape bit 1; the W
escape bits follow as ceil(W/16) lanes of 16 bits. Parity lanes are
stored as 4-byte words (B = 4096: 1088 lanes, 4352-byte parity).

GF16 data blocks (B bytes -> B/2 lanes): little-endian u16 words. Parity
value 0x10000 does not fit a u16: it is stored as 0 with a bit set in a
W-bit bitmap appended as ceil(W/16) u16 words.

Arithmetic runs on int64 carriers (PyTorch has no ``uint32``
arithmetic); byte <-> word conversions are bitcasts (``Tensor.view``) on
little-endian hosts and devices.

While a profiler records, :func:`pack_data` runs inside the span
``fecc.packing.pack_data`` and :func:`serialize_parity` inside
``fecc.packing.serialize_parity`` (``utils.profiling.scope``; the GF32
serialization is a view and launches nothing). :data:`PACKED` counts the
packs and their sizes.
"""

from __future__ import annotations

import torch

from . import gf
from .fields import FieldSpec
from .utils import profiling

BLOCK_BYTES = 4096  # default wire-format block size

# Packs run (pack_data calls), the raw words they read and the field lanes
# they wrote, summed over every row: sizes from the shapes, never a sync.
PACKED = {"pack": 0, "pack_words": 0, "pack_lanes": 0}


def reset_packed() -> None:
    """Zero :data:`PACKED`."""
    for key in PACKED:
        PACKED[key] = 0


def _word_count(field: FieldSpec, block_bytes: int) -> int:
    wb = 4 if field.use_mont else 2
    if block_bytes % wb:
        raise ValueError(f"{field.name} needs block_bytes % {wb} == 0, "
                         f"got {block_bytes}")
    return block_bytes // wb


def _bitmap_lanes(words: int) -> int:
    return -(-words // 16)


def field_lanes(field: FieldSpec, block_bytes: int = BLOCK_BYTES) -> int:
    """Number of field-element lanes a data block maps to."""
    w = _word_count(field, block_bytes)
    return w + _bitmap_lanes(w) if field.use_mont else w


def parity_bytes(field: FieldSpec, block_bytes: int = BLOCK_BYTES) -> int:
    """Wire size of one serialized parity block."""
    w = _word_count(field, block_bytes)
    if field.use_mont:
        return 4 * (w + _bitmap_lanes(w))
    return 2 * (w + _bitmap_lanes(w))


def _bytes_to_u32(raw: torch.Tensor, word_bytes: int) -> torch.Tensor:
    """[..., nbytes] uint8 -> [..., nbytes/word_bytes] ``torch.uint32``,
    little-endian (a bitcast)."""
    raw = raw.contiguous()
    if word_bytes == 4:
        return raw.view(torch.uint32)
    assert word_bytes == 2
    return (raw.view(torch.int16).to(torch.int32) & 0xFFFF).view(
        torch.uint32)


def _u32_to_bytes(words: torch.Tensor, word_bytes: int) -> torch.Tensor:
    """Inverse of :func:`_bytes_to_u32` (word_bytes == 2 keeps the low
    16 bits of each word)."""
    words = words.contiguous()
    if word_bytes == 4:
        return words.view(torch.uint8)
    assert word_bytes == 2
    h = words.view(torch.int32) & 0xFFFF
    return (h - ((h >> 15) << 16)).to(torch.int16).view(torch.uint8)


def _pack_bits(bits: torch.Tensor, group: int) -> torch.Tensor:
    """[..., L] 0/1 carriers -> [..., ceil(L/group)] carriers (bit j of
    word m is element m*group + j; trailing bits zero). The shift-or
    form; the reference's MXU form on the TPU gives the same bits."""
    length = bits.shape[-1]
    pad = (-length) % group
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    n_words = bits.shape[-1] // group
    b = bits.reshape(bits.shape[:-1] + (n_words, group))
    shifts = torch.arange(group, dtype=torch.int64, device=bits.device)
    return (b << shifts).sum(dim=-1)


def _unpack_bits(words: torch.Tensor, group: int,
                 length: int | None = None) -> torch.Tensor:
    """Inverse of :func:`_pack_bits` (truncated to ``length`` elements)."""
    shifts = torch.arange(group, dtype=torch.int64, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * group,))
    return flat if length is None else flat[..., :length]


def _words_from_lanes(lanes: int) -> int:
    """Invert lanes = W + ceil(W/16)."""
    w = lanes * 16 // 17
    while w + _bitmap_lanes(w) < lanes:
        w += 1
    if w + _bitmap_lanes(w) != lanes:
        raise ValueError(f"invalid lane count {lanes}")
    return w


def _escape_gf32(words: torch.Tensor, field: FieldSpec) -> torch.Tensor:
    """u32 words -> u32 [stored lanes | escape bitmap lanes]."""
    w = gf.widen(words)
    esc = (w >= field.p).to(torch.int64)
    stored = w - esc * field.p
    return gf.narrow(torch.cat([stored, _pack_bits(esc, 16)], dim=-1))


def _unescape_gf16(words: torch.Tensor) -> torch.Tensor:
    """u32 [stored u16 words | bitmap u16 words] -> u32 field values."""
    w = gf.widen(words)
    words_n = _words_from_lanes(w.shape[-1])
    stored, bitmap = w[..., :words_n], w[..., words_n:]
    esc = _unpack_bits(bitmap, 16, words_n)
    return gf.narrow(stored + esc * 0x10000)


# ---------------------------------------------------------------------------
# Data blocks: raw bytes -> field lanes (and back).
# ---------------------------------------------------------------------------

def pack_data(raw: torch.Tensor, field: FieldSpec) -> torch.Tensor:
    """[k, B] uint8 -> [k, field_lanes(field, B)] u32 field elements."""
    if raw.dtype != torch.uint8:
        raise TypeError(f"pack_data needs uint8 blocks, got {raw.dtype}")
    with profiling.scope("fecc.packing.pack_data"):
        words = _bytes_to_u32(raw, 4 if field.use_mont else 2)
        out = _escape_gf32(words, field) if field.use_mont else words
        PACKED["pack"] += 1
        PACKED["pack_words"] += words.numel()
        PACKED["pack_lanes"] += out.numel()
        return out


def unpack_data(fields: torch.Tensor, field: FieldSpec) -> torch.Tensor:
    """[k, field_lanes] u32 field elements -> [k, B] uint8."""
    if not field.use_mont:
        return _u32_to_bytes(fields, 2)
    f = gf.widen(fields)
    words_n = _words_from_lanes(f.shape[-1])
    stored, bitmap = f[..., :words_n], f[..., words_n:]
    esc = _unpack_bits(bitmap, 16, words_n)
    return _u32_to_bytes(gf.narrow(stored + esc * field.p), 4)


# ---------------------------------------------------------------------------
# Parity blocks: field lanes -> wire bytes (and back).
# ---------------------------------------------------------------------------

def serialize_parity(fields: torch.Tensor, field: FieldSpec) -> torch.Tensor:
    """[m, field_lanes] u32 field elements -> [m, parity_bytes] uint8."""
    with profiling.scope("fecc.packing.serialize_parity"):
        if field.use_mont:
            return _u32_to_bytes(fields, 4)
        f = gf.widen(fields)
        esc = (f == 0x10000).to(torch.int64)
        stored = f * (1 - esc)                       # 0 where escaped
        out = torch.cat([stored, _pack_bits(esc, 16)], dim=-1)
        return _u32_to_bytes(gf.narrow(out), 2)


def deserialize_parity(raw: torch.Tensor, field: FieldSpec) -> torch.Tensor:
    """[m, parity_bytes] uint8 -> [m, field_lanes] u32 field elements."""
    if field.use_mont:
        return _bytes_to_u32(raw, 4)
    return _unescape_gf16(_bytes_to_u32(raw, 2))


# ---------------------------------------------------------------------------
# Parts forms: u32 little-endian byte images instead of uint8 arrays (the
# wire bytes ARE these arrays' byte image).
# ---------------------------------------------------------------------------

def _split_halves(words: torch.Tensor) -> torch.Tensor:
    """[m, W] u32 pairs of LE u16 words -> [m, 2W] u32 (lo, hi, ...)."""
    w = gf.widen(words)
    m = w.shape[0]
    return gf.narrow(torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(
        m, w.shape[-1] * 2))


def pack_data_pairs(words: torch.Tensor, field: FieldSpec) -> torch.Tensor:
    """[k, B/4] u32 LE byte image of raw data blocks -> [k, field_lanes]
    u32 field elements (parts twin of :func:`pack_data`)."""
    if field.use_mont:
        return _escape_gf32(words, field)
    return _split_halves(words)


def deserialize_parity_pairs(pairs: torch.Tensor,
                             field: FieldSpec) -> torch.Tensor:
    """[m, parity_bytes/4] u32 LE byte image of wire parity ->
    [m, field_lanes] u32 field elements (parts twin of
    :func:`deserialize_parity`)."""
    if field.use_mont:
        return pairs
    return _unescape_gf16(_split_halves(pairs))


def data_rows_to_pairs(rows: torch.Tensor, field: FieldSpec) -> torch.Tensor:
    """[k, field_lanes] u32 DATA-block field rows -> [k, B/4] u32 LE byte
    image of the raw blocks (inverse of :func:`pack_data` up to the free
    byte view; parts twin of :func:`unpack_data`)."""
    r = gf.widen(rows)
    if field.use_mont:
        words_n = _words_from_lanes(r.shape[-1])
        stored, bitmap = r[..., :words_n], r[..., words_n:]
        esc = _unpack_bits(bitmap, 16, words_n)
        return gf.narrow((stored + esc * field.p) & gf.MASK32)
    return gf.narrow((r[..., 0::2] | (r[..., 1::2] << 16)) & gf.MASK32)
