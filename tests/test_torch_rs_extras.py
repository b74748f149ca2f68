"""Port vs reference: the rs extras (partial-stripe updates, codeword
verification, stripe batches, the lane-chunk streams) and decode_stream.

Same numpy inputs (from a seed) through both packages on the CPU, where
the port's transforms run the kernels' plain versions; every comparison
is exact (tolerance 0: integer arithmetic). The updates are also held to
a re-encode of the modified data, the streams to one call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastecc_tpu import decode as jdec
from fastecc_tpu import fields as jfields
from fastecc_tpu import rs as jrs
from fastecc_tpu_torch import decode, fields, gf, rs, testing
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32

torch.set_num_threads(1)

RNG = np.random.default_rng(0xE7A5)
FIELDS = [fields.GF32, fields.GF16]
RATES = [(64, 128), (32, 128)]        # (k, n): rate 1/2 and rate 1/4


def _ref(field):
    return jfields.FIELDS[field.name]


def rand_field(field, shape):
    return RNG.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)


def encode_parity_np(data, field, n):
    return to_numpy_u32(rs.encode_parity(data, field, n, device="cpu"))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_update_tables_match_reference(field):
    for n, k in ((16, 8), (64, 16), (512, 256)):
        for mine, theirs in zip(rs._update_point_tables(field.name, n, k),
                                jrs._update_point_tables(field.name, n, k)):
            np.testing.assert_array_equal(mine, theirs)
        for i in (0, 1, k // 2, k - 1):
            np.testing.assert_array_equal(
                rs._update_row_consts(field.name, n, k, i),
                jrs._update_row_consts(field.name, n, k, i))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("k,n", RATES)
def test_update_parity_matches_reference_and_reencode(field, k, n):
    lanes = 5
    data = rand_field(field, (k, lanes))
    par = encode_parity_np(data, field, n)
    i = k // 3
    new = rand_field(field, lanes)
    got = to_numpy_u32(rs.update_parity(par, i, data[i], new, field, n,
                                        device="cpu"))
    np.testing.assert_array_equal(got, np.asarray(jrs.update_parity(
        jnp.asarray(par), i, jnp.asarray(data[i]), jnp.asarray(new),
        _ref(field), n)))
    data[i] = new
    np.testing.assert_array_equal(got, encode_parity_np(data, field, n))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("k,n", RATES)
def test_update_parity_multi_matches_reference_and_reencode(field, k, n):
    lanes = 6
    data = rand_field(field, (k, lanes))
    par = encode_parity_np(data, field, n)
    idxs = (0, 7, k - 1)
    new = rand_field(field, (3, lanes))
    got = to_numpy_u32(rs.update_parity_multi(
        from_numpy_u32(par, "cpu"), idxs, data[list(idxs)], new, field, n))
    np.testing.assert_array_equal(got, np.asarray(jrs.update_parity_multi(
        jnp.asarray(par), idxs, jnp.asarray(data[list(idxs)]),
        jnp.asarray(new), _ref(field), n)))
    data[list(idxs)] = new
    np.testing.assert_array_equal(got, encode_parity_np(data, field, n))
    same = rs.update_parity_multi(par, (), data[:0], data[:0], field, n,
                                  device="cpu")
    np.testing.assert_array_equal(to_numpy_u32(same), par)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_apply_parity_update_row_slices(field, monkeypatch):
    """apply_parity_update on a row slice == the reference's, and its row
    blocks (forced small here) change no bit."""
    k, n, lanes = 32, 64, 4
    vs = np.stack([rs._update_row_consts(field.name, n, k, i)
                   for i in (2, 9)])
    par = rand_field(field, (n - k, lanes))
    delta = rand_field(field, (2, lanes))
    want = np.asarray(jrs.apply_parity_update(
        jnp.asarray(par[8:24]), jnp.asarray(vs[:, 8:24]),
        jnp.asarray(delta), _ref(field)))
    got = rs.apply_parity_update(par[8:24], vs[:, 8:24], delta, field,
                                 device="cpu")
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    monkeypatch.setattr(rs, "_UPDATE_BLOCK", 3 * lanes)
    got = rs.apply_parity_update(par[8:24], vs[:, 8:24], delta, field,
                                 device="cpu")
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_update_parity_contracts_raise_value_error():
    f = fields.GF32
    par = np.zeros((8, 2), np.uint32)
    blk = np.zeros((1, 2), np.uint32)
    with pytest.raises(ValueError, match="indices"):
        rs.update_parity_multi(par, (1, 2), blk, blk, f, device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 8\)"):
        rs.update_parity_multi(par, (8,), blk, blk, f, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        rs.update_parity_multi(par, (1,), blk, blk, f, n=12, device="cpu")


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("k,n", RATES)
def test_verify_codeword_matches_reference(field, k, n):
    data = rand_field(field, (k, 3))
    cw = to_numpy_u32(rs.encode(data, field, n, device="cpu"))
    got = rs.verify_codeword(cw, field, k, device="cpu")
    assert got.dtype == torch.bool and got.dim() == 0 and bool(got)
    assert bool(jrs.verify_codeword(jnp.asarray(cw), _ref(field), k))
    bad = cw.copy()
    bad[n // 3, 1] = (int(bad[n // 3, 1]) + 1) % field.p
    assert not bool(rs.verify_codeword(bad, field, k, device="cpu"))
    assert not bool(jrs.verify_codeword(jnp.asarray(bad), _ref(field), k))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("k,n", RATES)
def test_encode_parity_batch_matches_reference(field, k, n):
    batch = rand_field(field, (3, k, 4))
    got = to_numpy_u32(rs.encode_parity_batch(batch, field, n, device="cpu"))
    np.testing.assert_array_equal(got, np.asarray(jrs.encode_parity_batch(
        jnp.asarray(batch), _ref(field), n)))
    for s in range(3):
        np.testing.assert_array_equal(got[s],
                                      encode_parity_np(batch[s], field, n))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("chunk", [16, 64, 100])
def test_encode_parity_stream_matches_reference(field, chunk):
    """Chunks of 16 (4 of them), 64 (one) and 100 (more than the lanes)
    all give the one-call parity, and the reference's stream."""
    k, lanes = 32, 64
    data = rand_field(field, (k, lanes))
    got = rs.encode_parity_stream(data, field, chunk_lanes=chunk,
                                  device="cpu")
    np.testing.assert_array_equal(got, encode_parity_np(data, field, 2 * k))
    np.testing.assert_array_equal(got, jrs.encode_parity_stream(
        data, _ref(field), chunk_lanes=chunk))
    out = np.zeros((3 * k, lanes), np.uint32)
    res = rs.encode_parity_stream(data, field, 4 * k, chunk_lanes=chunk,
                                  out=out, device="cpu")
    assert res is out
    np.testing.assert_array_equal(out, encode_parity_np(data, field, 4 * k))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_decode_stream_matches_reference(field):
    n, k, lanes = 128, 64, 48
    data = rand_field(field, (k, lanes))
    cw = to_numpy_u32(rs.encode(data, field, n, device="cpu"))
    erased = testing.random_erasures(n, n - k, seed=11)
    bad = cw.copy()
    bad[erased] = 7
    got = decode.decode_stream(bad, erased, field, chunk_lanes=16, k=k,
                               device="cpu")
    np.testing.assert_array_equal(got, cw)
    np.testing.assert_array_equal(got, jdec.decode_stream(
        bad, erased, _ref(field), chunk_lanes=16, k=k))
    np.testing.assert_array_equal(got, to_numpy_u32(
        decode.decode_host_prepared(bad, erased, field, device="cpu")))


def test_stream_contracts_raise_value_error():
    f = fields.GF32
    data = np.zeros((8, 48), np.uint32)
    with pytest.raises(ValueError, match="must divide"):
        rs.encode_parity_stream(data, f, chunk_lanes=32, device="cpu")
    cw = np.zeros((16, 48), np.uint32)
    with pytest.raises(ValueError, match="must divide"):
        decode.decode_stream(cw, [1, 2], f, chunk_lanes=32, device="cpu")
    with pytest.raises(ValueError, match="unrecoverable"):
        decode.decode_stream(cw, np.arange(9), f, k=8, device="cpu")


class _Recorder:
    """A host 'out' array that logs which lane offset each write lands at."""

    def __init__(self, rows, lanes, log):
        self.a = np.zeros((rows, lanes), np.uint32)
        self.log = log

    def __setitem__(self, key, value):
        self.log.append(("drain", key[1].start))
        self.a[key] = value


def test_stream_lane_chunks_keeps_two_in_flight():
    """Chunk i-2 is drained before chunk i is dispatched (depth 2), every
    chunk lands at its offset, and the rest drain in order at the end."""
    log = []

    def dispatch(off):
        log.append(("dispatch", off))
        return gf.narrow(torch.full((2, 4), off, dtype=torch.int64))

    out = _Recorder(2, 16, log)
    rs.stream_lane_chunks(16, 4, dispatch, out)
    assert log == [("dispatch", 0), ("dispatch", 4), ("drain", 0),
                   ("dispatch", 8), ("drain", 4), ("dispatch", 12),
                   ("drain", 8), ("drain", 12)]
    np.testing.assert_array_equal(out.a[0], np.repeat([0, 4, 8, 12], 4))
