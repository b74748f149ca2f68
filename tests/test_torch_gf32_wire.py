"""The GF32 wire encode of raw bytes (``rs.encode_blocks`` with GF32:
``packing.pack_data`` -> ``encode_parity`` at W + W/16 lanes ->
``serialize_parity``) on the CPU, exact: against the reference package's
``encode_blocks`` and against the plain reference of the benchmark
(``ecbench/reference/gf32_wire.py`` with ``rs.py``: int64 torch, nothing
of the port), on seeded bytes with all-0xFF blocks and words just above
and below p; the same bits with the profiler on and off; the pack's and
the serialization's spans; and :data:`packing.PACKED`'s counts."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

from ecbench.reference import gf32_wire as ref_wire
from ecbench.reference import rs as ref
from fastecc_tpu import fields as jfields
from fastecc_tpu import rs as jrs
from fastecc_tpu_torch import packing, rs
from fastecc_tpu_torch.fields import GF16, GF32

torch.set_num_threads(1)

P = GF32.p
# (k, B): one bitmap lane, the wire format's 4 KB blocks, and 4 lanes
SHAPES = [(64, 64), (256, 4096), (512, 256)]
PACK = "fecc.packing.pack_data"
SERIALIZE = "fecc.packing.serialize_parity"


def _raw(k: int, block_bytes: int, seed: int) -> np.ndarray:
    """[k, B] seeded bytes: uniform, with 1/8 of the blocks all 0xFF and
    1/8 of them words drawn from p - 4 .. p + 3 and the top of the range."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (k, block_bytes), dtype=np.uint8)
    rows = rng.permutation(k)
    raw[rows[:k // 8]] = 0xFF
    near = np.array([P - 4, P - 3, P - 2, P - 1, P, P + 1, P + 2, P + 3,
                     0xFFFFFFFE, 0xFFFFFFFF, 0, 1], np.uint64)
    edge = rng.choice(near, (k // 8, block_bytes // 4)).astype("<u4")
    raw[rows[k // 8:k // 4]] = edge.view(np.uint8).reshape(k // 8, -1)
    return raw


def _plain(raw: np.ndarray) -> np.ndarray:
    """The benchmark's plain reference: pack, encode, serialize."""
    t = torch.from_numpy(raw)
    words = ref_wire.gf32_words(t)
    return ref_wire.gf32_wire(ref.Field("GF32").encode_parity(
        words, 2 * t.shape[0])).numpy()


@pytest.mark.parametrize("k,block_bytes", SHAPES)
def test_encode_blocks_gf32_matches_both_references(k, block_bytes):
    raw = _raw(k, block_bytes, 0xB10C + k + block_bytes)
    words = raw.view("<u4")
    assert (words >= P).mean() > 0.15     # the 0xFF and edge rows escape
    got = rs.encode_blocks(torch.from_numpy(raw), GF32, device="cpu")
    lanes = block_bytes // 4 + -(-block_bytes // 64)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == (k, 4 * lanes)
    got = got.numpy()
    want = np.asarray(jrs.encode_blocks(jnp.asarray(raw), jfields.GF32,
                                        2 * k))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _plain(raw))


@pytest.mark.parametrize("k,block_bytes", SHAPES)
def test_pack_data_matches_the_plain_reference(k, block_bytes):
    raw = _raw(k, block_bytes, 0xFACC + k)
    got = packing.pack_data(torch.from_numpy(raw), GF32)
    want = ref_wire.gf32_words(torch.from_numpy(raw))
    np.testing.assert_array_equal(ref.u32_to_i64(got).numpy(),
                                  want.numpy())
    # and back: the pack loses no bit
    np.testing.assert_array_equal(packing.unpack_data(got, GF32).numpy(),
                                  raw)


def test_all_ff_block_packs_to_escaped_words():
    raw = torch.full((1, 4096), 0xFF, dtype=torch.uint8)
    lanes = ref.u32_to_i64(packing.pack_data(raw, GF32))[0]
    assert lanes.shape == (1088,)
    assert set(lanes[:1024].tolist()) == {0xFFFFFFFF - P}
    assert set(lanes[1024:].tolist()) == {0xFFFF}


def _calls():
    raw = torch.from_numpy(_raw(64, 256, 0x5BA7))
    return {"encode_blocks": lambda: rs.encode_blocks(raw, GF32),
            "pack_data": lambda: packing.pack_data(raw, GF32),
            "serialize_parity": lambda: packing.serialize_parity(
                packing.pack_data(raw, GF32), GF32),
            "encode_blocks_gf16_generic": lambda: rs.encode_blocks(
                raw, GF16, 256)}


@pytest.mark.parametrize("name", sorted(_calls()))
def test_same_bits_with_the_profiler_on_and_off(name):
    call = _calls()[name]
    off = call()
    with profile(activities=[ProfilerActivity.CPU]):
        on = call()
    assert on.dtype == off.dtype
    assert torch.equal(on.view(torch.uint8), off.view(torch.uint8))
    assert torch.equal(call().view(torch.uint8), off.view(torch.uint8))


def _spans(prof) -> list:
    """(name, start, end) of the profile's ``fecc.`` spans by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("fecc."))


@pytest.mark.parametrize("field,n_mult", [(GF32, 2), (GF16, 4)],
                         ids=["gf32", "gf16_generic"])
def test_pack_and_serialize_spans_in_a_profiled_call(field, n_mult):
    raw = torch.from_numpy(_raw(16, 64, 0x5A))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rs.encode_blocks(raw, field, n_mult * 16)
    found = _spans(prof)
    names = [n for _, _, n in found]
    assert names.count(PACK) == 1 and names.count(SERIALIZE) == 1
    (s0, e0, entry), = [f for f in found if f[2] == "fecc.rs.encode_blocks"]
    pack = next(f for f in found if f[2] == PACK)
    enc = next(f for f in found if f[2] == "fecc.rs.encode_parity")
    ser = next(f for f in found if f[2] == SERIALIZE)
    # inside the entry, in the order pack -> encode -> serialize
    assert s0 <= pack[0] and ser[1] <= e0
    assert pack[1] <= enc[0] and enc[1] <= ser[0]


def test_no_pack_span_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span {name!r} opened")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    raw = torch.from_numpy(_raw(16, 64, 0x0FF))
    packing.serialize_parity(packing.pack_data(raw, GF32), GF32)


@pytest.mark.parametrize("field,block_bytes,words,lanes", [
    (GF32, 4096, 1024, 1088), (GF32, 64, 16, 17), (GF32, 72, 18, 20),
    (GF16, 256, 128, 128)], ids=["gf32_4k", "gf32_64", "gf32_72", "gf16"])
def test_packed_counts_the_packs(field, block_bytes, words, lanes):
    k = 8
    raw = torch.zeros((k, block_bytes), dtype=torch.uint8)
    packing.reset_packed()
    assert packing.PACKED == {"pack": 0, "pack_words": 0, "pack_lanes": 0}
    for _ in range(3):
        out = packing.pack_data(raw, field)
    assert tuple(out.shape) == (k, lanes)
    assert packing.PACKED == {"pack": 3, "pack_words": 3 * k * words,
                              "pack_lanes": 3 * k * lanes}
    packing.serialize_parity(out, field)
    packing.unpack_data(out, field)
    assert packing.PACKED["pack"] == 3      # only packs count
    packing.reset_packed()
    assert set(packing.PACKED.values()) == {0}


def test_encode_blocks_packs_once_a_call():
    packing.reset_packed()
    rs.encode_blocks(torch.from_numpy(_raw(64, 256, 0x1)), GF32)
    assert packing.PACKED == {"pack": 1, "pack_words": 64 * 64,
                              "pack_lanes": 64 * 68}
    packing.reset_packed()
