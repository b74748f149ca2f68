"""Port vs reference: the wire format (fastecc_tpu_torch.packing vs
fastecc_tpu.packing) and the byte-level goldens of
tests/test_wire_golden.py, reproduced by the port on the CPU."""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastecc_tpu import fields as jfields
from fastecc_tpu import packing as jpacking
from fastecc_tpu_torch import fields, packing, rs
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32

torch.set_num_threads(1)

GF32, GF16 = fields.GF32, fields.GF16


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _u8(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _data_blocks_gf32() -> np.ndarray:
    rng = np.random.default_rng(0xC13)
    w = rng.integers(0, 1 << 32, size=(4, 1024),
                     dtype=np.uint64).astype(np.uint32)
    w[0, :8] = [0, 1, GF32.p - 1, GF32.p, GF32.p + 1,
                0xFFFFFFFF, 0xFFF00000, 0xFFFFFFFE]
    raw = np.frombuffer(w.astype("<u4").tobytes(),
                        np.uint8).reshape(4, 4096).copy()
    assert _sha(raw) == ("97a84b82e7a7e222bceb2db7c583f934"
                         "df85cfc613fa36f06c360298177a9dc5")
    return raw


def _data_blocks_gf16() -> np.ndarray:
    rng = np.random.default_rng(0xC13)
    rng.integers(0, 1 << 32, size=(4, 1024), dtype=np.uint64)  # skip
    raw = rng.integers(0, 256, size=(4, 4096),
                       dtype=np.uint16).astype(np.uint8)
    assert _sha(raw) == ("a31ddcd1d0ef05689af763482cd9a660"
                         "5b9771a39cc96798567c1ad9246efe65")
    return raw


def _skip_draws(rng, count):
    draws = [lambda: rng.integers(0, 1 << 32, size=(4, 1024),
                                  dtype=np.uint64),
             lambda: rng.integers(0, 256, size=(4, 4096), dtype=np.uint16),
             lambda: rng.integers(0, GF32.p, size=(3, 1088),
                                  dtype=np.uint64)]
    for d in draws[:count]:
        d()


def test_pack_data_golden_gf32():
    packed = to_numpy_u32(packing.pack_data(_u8(_data_blocks_gf32()), GF32))
    assert packed.shape == (4, 1088)
    assert _sha(packed) == ("991b8acb76af423f6fe33d94942ffe7e"
                            "431e417c3361ba06b6f42fc09c18a08d")


def test_pack_data_golden_gf16():
    packed = to_numpy_u32(packing.pack_data(_u8(_data_blocks_gf16()), GF16))
    assert packed.shape == (4, 2048)
    assert _sha(packed) == ("7bd98a7b738591fa2a830cd9425a2158"
                            "1f01e74b909c15940611ff0d893b95b7")


def test_serialize_parity_golden_gf32():
    rng = np.random.default_rng(0xC13)
    _skip_draws(rng, 2)
    pf = rng.integers(0, GF32.p, size=(3, 1088),
                      dtype=np.uint64).astype(np.uint32)
    ser = packing.serialize_parity(from_numpy_u32(pf, "cpu"), GF32).numpy()
    assert ser.shape == (3, 4352)
    assert _sha(ser) == ("fe62c51587def8c07207d9a893a094af"
                         "cce9dab3313086c5c6ba918330fdcc34")


def test_serialize_parity_golden_gf16():
    rng = np.random.default_rng(0xC13)
    _skip_draws(rng, 3)
    pf = rng.integers(0, GF16.p - 1, size=(3, 2048),
                      dtype=np.uint64).astype(np.uint32)
    pf[0, [0, 15, 16, 2047]] = 0x10000
    pf[2, 100] = 0x10000
    ser = packing.serialize_parity(from_numpy_u32(pf, "cpu"), GF16)
    assert tuple(ser.shape) == (3, 4352)
    assert _sha(ser.numpy()) == ("ac60b01d7b6b5612272368c4e3eb3b8b"
                                 "b5cf3f5106420c22784722e8253795ca")
    np.testing.assert_array_equal(
        to_numpy_u32(packing.deserialize_parity(ser, GF16)), pf)


@pytest.mark.parametrize("field,digest", [
    (GF32, "c480d93efb75815a9cbb06c65f014789"
           "f4ea901e9929f50c11fc62cd542c7a9f"),
    (GF16, "bcc7aac37e2f7a4be2e6007fe7e881f0"
           "e0b4a42e8c2751f80862281d211d7b0e"),
], ids=["GF32", "GF16"])
def test_encode_blocks_parity_blob_golden(field, digest):
    raw = _data_blocks_gf32() if field.use_mont else _data_blocks_gf16()
    blob = rs.encode_blocks(raw, field, 8, device="cpu").numpy()
    assert blob.shape == (4, 4352)
    assert _sha(blob) == digest


@pytest.mark.parametrize("field", [GF32, GF16], ids=lambda f: f.name)
@pytest.mark.parametrize("block_bytes", [4096, 100, 36])
def test_pack_roundtrips_match_reference(field, block_bytes):
    rng = np.random.default_rng(block_bytes)
    raw = rng.integers(0, 256, size=(3, block_bytes), dtype=np.uint16
                       ).astype(np.uint8)
    raw[1, :8] = 0xFF
    rf = jfields.FIELDS[field.name]
    packed = packing.pack_data(_u8(raw), field)
    np.testing.assert_array_equal(
        to_numpy_u32(packed),
        np.asarray(jpacking.pack_data(jnp.asarray(raw), rf)))
    assert packed.shape[1] == packing.field_lanes(field, block_bytes)
    np.testing.assert_array_equal(packing.unpack_data(packed, field).numpy(),
                                  raw)
    assert packing.parity_bytes(field, block_bytes) == \
        jpacking.parity_bytes(rf, block_bytes)
    if block_bytes % 4 == 0:
        words = np.ascontiguousarray(raw).view(np.uint32)
        pairs = packing.pack_data_pairs(from_numpy_u32(words, "cpu"), field)
        np.testing.assert_array_equal(
            to_numpy_u32(pairs),
            np.asarray(jpacking.pack_data_pairs(jnp.asarray(words), rf)))


@pytest.mark.parametrize("field", [GF32, GF16], ids=lambda f: f.name)
def test_parity_serialization_matches_reference(field):
    rng = np.random.default_rng(7)
    lanes = packing.field_lanes(field, 4096)
    pf = rng.integers(0, field.p, size=(5, lanes),
                      dtype=np.uint64).astype(np.uint32)
    if not field.use_mont:
        pf[:, ::97] = 0x10000
    rf = jfields.FIELDS[field.name]
    ser = packing.serialize_parity(from_numpy_u32(pf, "cpu"), field)
    np.testing.assert_array_equal(
        ser.numpy(),
        np.asarray(jpacking.serialize_parity(jnp.asarray(pf), rf)))
    np.testing.assert_array_equal(
        to_numpy_u32(packing.deserialize_parity(ser, field)), pf)
    pairs = np.ascontiguousarray(ser.numpy()).view(np.uint32)
    np.testing.assert_array_equal(
        to_numpy_u32(packing.deserialize_parity_pairs(
            from_numpy_u32(pairs, "cpu"), field)),
        np.asarray(jpacking.deserialize_parity_pairs(jnp.asarray(pairs),
                                                     rf)))


def test_bit_packing_matches_reference():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, size=(4, 37)).astype(np.uint32)
    words = packing._pack_bits(torch.from_numpy(bits.astype(np.int64)), 16)
    want = np.asarray(jpacking._pack_bits(jnp.asarray(bits), 16))
    np.testing.assert_array_equal(words.numpy(), want)
    back = packing._unpack_bits(words, 16, 37)
    np.testing.assert_array_equal(back.numpy(), bits)
    with pytest.raises(ValueError, match="block_bytes"):
        packing.field_lanes(GF32, 4098)


@pytest.mark.parametrize("block_bytes", [4096, 160, 36])
@pytest.mark.parametrize("field", [GF32, GF16], ids=lambda f: f.name)
def test_data_rows_to_pairs_matches_reference(field, block_bytes):
    """data_rows_to_pairs on packed data rows (GF32 rows whose bitmap
    marks escapes, words >= p) and on raw random field rows (GF16 values
    up to 0x10000, GF32 bitmap lanes with random bits): the reference's
    u32 image, and on packed rows the inverse of pack_data."""
    rng = np.random.default_rng(0xD27 + block_bytes)
    raw = rng.integers(0, 256, (6, block_bytes), dtype=np.uint16).astype(
        np.uint8)
    raw[0, : min(64, block_bytes)] = 0xFF          # escapes in GF32
    jf = jfields.FIELDS[field.name]
    rows = np.asarray(jpacking.pack_data(jnp.asarray(raw), jf))
    lanes = rows.shape[1]
    if field.use_mont:
        assert rows[0, jpacking._words_from_lanes(lanes):].any()
    hi = field.p if field.use_mont else 0x10001
    wild = rng.integers(0, hi, (5, lanes), dtype=np.uint64).astype(np.uint32)
    if field.use_mont:
        words_n = jpacking._words_from_lanes(lanes)
        wild[:, words_n:] = rng.integers(0, 1 << 16, (5, lanes - words_n),
                                         dtype=np.uint32)
    for x in (rows, wild):
        got = to_numpy_u32(packing.data_rows_to_pairs(
            from_numpy_u32(x, "cpu"), field))
        want = np.asarray(jpacking.data_rows_to_pairs(jnp.asarray(x), jf))
        np.testing.assert_array_equal(got, want)
    back = to_numpy_u32(packing.data_rows_to_pairs(
        from_numpy_u32(rows, "cpu"), field))
    np.testing.assert_array_equal(back.view(np.uint8).reshape(raw.shape),
                                  raw)
