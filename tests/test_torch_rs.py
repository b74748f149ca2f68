"""Port vs reference: RS encode (fastecc_tpu_torch.rs vs fastecc_tpu.rs)
on the CPU, exact, plus the reference's golden codeword digests."""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastecc_tpu import fields as jfields
from fastecc_tpu import rs as jrs
from fastecc_tpu_torch import fields, interop, rs
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32

torch.set_num_threads(1)

RNG = np.random.default_rng(0x5EED5)
FIELDS = [fields.GF32, fields.GF16]


def rand_field(field, shape):
    return RNG.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _ref(field):
    return jfields.FIELDS[field.name]


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("k,n", [(8, 16), (64, 128), (64, 256), (256, 512)])
def test_encode_paths_match_reference(field, k, n):
    """encode_parity (rate 1/2: the K1->K2->K3 pair; else K1->K3 plus
    K4->K3 per coset), encode and encode_padded, all bit-exact."""
    data = rand_field(field, (k, 3))
    jd, td = jnp.asarray(data), from_numpy_u32(data, "cpu")
    rf = _ref(field)
    par = to_numpy_u32(rs.encode_parity(td, field, n))
    np.testing.assert_array_equal(par, np.asarray(
        jrs.encode_parity(jd, rf, n)))
    cw = to_numpy_u32(rs.encode(td, field, n))
    np.testing.assert_array_equal(cw, np.asarray(jrs.encode(jd, rf, n)))
    np.testing.assert_array_equal(
        to_numpy_u32(rs.encode_padded(td, field, n)), cw)
    np.testing.assert_array_equal(cw[rs.data_positions(n, k)], data)
    np.testing.assert_array_equal(cw[rs.parity_positions(n, k)], par)


def test_lane_chunks_bit_identical():
    data = rand_field(fields.GF32, (64, 16))
    full = rs.encode_parity(data, fields.GF32, device="cpu")
    for chunks in (2, 4):
        got = rs.encode_parity(data, fields.GF32, lane_chunks=chunks,
                               device="cpu")
        assert torch.equal(got, full)
    np.testing.assert_array_equal(to_numpy_u32(full), np.asarray(
        jrs.encode_parity(jnp.asarray(data), jfields.GF32, lane_chunks=4)))
    with pytest.raises(ValueError, match="lane_chunks"):
        rs.encode_parity(data, fields.GF32, lane_chunks=3, device="cpu")


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_golden_codeword_hash(field):
    """tests/test_rs.py's pinned SHA-256 of the k=64, 4-lane codeword."""
    golden = {
        "GF32": "edf67c1247ff14ab94dd84ec24f200b7"
                "b40c9b65814b764ab29e7bc4494101e2",
        "GF16": "6a407726e3d6a7ee6501f145b3dcf4be"
                "91ecb2871357991b466357ee0f472fae",
    }
    k, lanes = 64, 4
    i = np.arange(k, dtype=np.uint64)[:, None]
    l = np.arange(lanes, dtype=np.uint64)[None, :]
    data = ((i * 1000003 + l * 7919 + 1) % field.p).astype(np.uint32)
    cw = to_numpy_u32(rs.encode(data, field, 2 * k, device="cpu"))
    assert hashlib.sha256(cw.tobytes()).hexdigest() == golden[field.name]


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_coset_twiddles_match_reference(field):
    for n, k in ((16, 8), (256, 64), (1 << 10, 1 << 8)):
        np.testing.assert_array_equal(
            rs._coset_twiddles(field.name, n, k),
            jrs._coset_twiddles(field.name, n, k))


def test_positions_and_kn_checks():
    for n, k in ((16, 8), (64, 16)):
        np.testing.assert_array_equal(rs.data_positions(n, k),
                                      jrs.data_positions(n, k))
        np.testing.assert_array_equal(rs.parity_positions(n, k),
                                      jrs.parity_positions(n, k))
    x = np.zeros((8, 2), np.uint32)
    for n in (8, 12, 4):
        with pytest.raises(ValueError):
            rs.encode_parity(x, fields.GF32, n, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        rs.encode_parity(np.zeros((6, 2), np.uint32), fields.GF32, 12,
                         device="cpu")


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("n_mult", [2, 4])
def test_encode_blocks_match_reference(field, n_mult):
    """Raw bytes in, wire parity out, with all-0xFF (escape) content."""
    k = 16
    raw = RNG.integers(0, 256, size=(k, 512), dtype=np.uint16).astype(
        np.uint8)
    raw[0, :] = 0xFF
    got = rs.encode_blocks(raw, field, n_mult * k, device="cpu")
    assert got.dtype == torch.uint8
    want = np.asarray(jrs.encode_blocks(jnp.asarray(raw), _ref(field),
                                        n_mult * k))
    np.testing.assert_array_equal(got.numpy(), want)
    if field.use_mont:
        words = np.ascontiguousarray(raw).view(np.uint32)
        parts = rs.encode_blocks_parts(words, field, n_mult * k,
                                       device="cpu")
        np.testing.assert_array_equal(
            np.ascontiguousarray(to_numpy_u32(parts)).view(np.uint8), want)


def test_encode_blocks_parts_is_gf32_only():
    with pytest.raises(ValueError, match="GF32"):
        rs.encode_blocks_parts(np.zeros((4, 8), np.uint32), fields.GF16,
                               device="cpu")


def test_interop_roundtrip_and_field_names():
    a = rand_field(fields.GF32, (5, 7))
    t = interop.from_numpy_u32(a, "cpu")
    assert t.dtype == torch.uint32 and t.device.type == "cpu"
    np.testing.assert_array_equal(interop.to_numpy_u32(t), a)
    assert interop.field_by_name("GF16") is fields.GF16
    with pytest.raises(ValueError, match="unknown field"):
        interop.field_by_name("GF8")
    with pytest.raises(TypeError):
        interop.from_numpy_u32(a.astype(np.int64), "cpu")
