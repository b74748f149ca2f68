"""Port vs reference: the one-pass lanes pair (K11, K12) and its opt-in
dispatch (fastecc_tpu_torch.kernels.ntt_mfa vs
fastecc_tpu.kernels.ntt_mfa).

Same numpy inputs (from a seed) through both packages on the CPU, where
the port's wrappers run their plain versions and the Pallas kernels run in
interpret mode, as tests/test_pallas.py runs them; every comparison is
exact (tolerance 0: integer arithmetic). The CUDA kernels are held to the
plain versions by tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastecc_tpu import decode as jdec
from fastecc_tpu import fields as jfields
from fastecc_tpu import rs as jrs
from fastecc_tpu.kernels import ntt_mfa as jmfa
from fastecc_tpu_torch import decode, fields, rs
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
from fastecc_tpu_torch.kernels import ntt_mfa as m

torch.set_num_threads(1)

RNG = np.random.default_rng(0x1A7E5)
FIELDS = [fields.GF32, fields.GF16]
GF16 = fields.GF16


def _ref(field):
    return jfields.FIELDS[field.name]


def rand_field(field, shape):
    return RNG.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)


def t(a):
    return from_numpy_u32(np.asarray(a, np.uint32), "cpu")


@pytest.fixture
def lanes_on(monkeypatch):
    """The lanes pair switched on in both packages."""
    monkeypatch.setattr(m, "LANES_PAIR_ENABLED", True)
    monkeypatch.setattr(jmfa, "LANES_PAIR_ENABLED", True)


def count_calls(monkeypatch, name):
    calls = []
    real = getattr(m, name)
    monkeypatch.setattr(m, name, lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("k", [1 << 7, 1 << 9])
def test_pair_lanes_matches_pallas(field, k):
    """K11's plain version (and its wrapper on a CPU tensor) vs
    ntt_pair_lanes_pallas in interpret mode and vs the three-pass pair."""
    x = rand_field(field, (k, 256))
    g = field.root_of_order(2 * k)
    want = np.asarray(jmfa.ntt_pair_lanes_pallas(jnp.asarray(x), _ref(field),
                                                 g, interpret=True))
    got = m.pair_lanes_plain(t(x), field, g)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    assert torch.equal(m.ntt_pair_lanes(t(x), field, g), got)
    assert torch.equal(m.ntt_pair(t(x), field, pre_seed2=g), got)
    assert set(m.LAUNCHES.values()) == {0}       # CPU: no launch counted


def _wire16_case():
    """tests/test_pallas.py's escape case: k = 2^8 blocks of 4 KB under
    default_rng(0), whose parity holds 0x10000 values."""
    k = 1 << 8
    raw = np.random.default_rng(0).integers(0, 256, (k, 4096),
                                            dtype=np.uint8)
    return k, raw, np.ascontiguousarray(raw).view(np.uint32)


def test_pair_lanes_wire16_matches_pallas():
    """K12's plain version vs ntt_pair_lanes_wire16_pallas in interpret
    mode and vs the port's three-pass wire route (K8 -> K9 -> K10), with
    escape bits present."""
    k, _, pairs = _wire16_case()
    g = GF16.root_of_order(2 * k)
    st, bm = m.pair_lanes_wire16_plain(t(pairs), GF16, g)
    st_ref, bm_ref = jmfa.ntt_pair_lanes_wire16_pallas(
        jnp.asarray(pairs), jfields.GF16, g, interpret=True)
    np.testing.assert_array_equal(to_numpy_u32(st), np.asarray(st_ref))
    np.testing.assert_array_equal(to_numpy_u32(bm), np.asarray(bm_ref))
    assert to_numpy_u32(bm).any(), "case no longer hits escapes"
    st3, bm3 = m.ntt_coset_pair_wire16(t(pairs), GF16, g)   # lanes off
    assert torch.equal(st, st3) and torch.equal(bm, bm3)
    st_w, bm_w = m.ntt_pair_lanes_wire16(t(pairs), GF16, g)
    assert torch.equal(st, st_w) and torch.equal(bm, bm_w)


def test_lanes_gate(monkeypatch):
    """Off by default, as in the reference; on, k a power of two in
    [32, 2^13]."""
    assert not m.LANES_PAIR_ENABLED and not jmfa.LANES_PAIR_ENABLED
    assert not m._pair_lanes_supported(1 << 10, 1024)
    monkeypatch.setattr(m, "LANES_PAIR_ENABLED", True)
    for k in (32, 1 << 10, m.MAX_LANES_K):
        assert m._pair_lanes_supported(k, 1)
    assert m.MAX_LANES_K == 1 << 13 and m.MIN_LANES_K == 32
    assert not m._pair_lanes_supported(16, 1024)         # below 32
    assert not m._pair_lanes_supported(1 << 14, 1024)    # above 2^13
    assert not m._pair_lanes_supported(48, 1024)         # not a power of two
    assert not m._pair_lanes_supported(64, 0)


def test_lanes_contracts_raise_value_error():
    words = t(np.zeros((64, 12), np.uint32))
    with pytest.raises(ValueError, match="GF16 path"):
        m.ntt_pair_lanes_wire16(words[:, :8].contiguous(), fields.GF32, 3)
    with pytest.raises(ValueError, match="Wu % 8"):
        m.ntt_pair_lanes_wire16(words, GF16, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        m._lanes_input(torch.empty((64, 8), dtype=torch.uint32,
                                   device="meta"), "ntt_pair_lanes")


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_encode_parity_through_lanes(field, lanes_on, monkeypatch):
    """With the flag on in both packages, rs.encode_parity at rate 1/2
    takes K11 where the gate allows it and equals the reference's; below
    the gate the three passes run."""
    for k, lanes, via_lanes in ((1 << 7, 256, True), (16, 256, False)):
        data = rand_field(field, (k, lanes))
        calls = count_calls(monkeypatch, "ntt_pair_lanes")
        got = rs.encode_parity(data, field, device="cpu")
        assert len(calls) == int(via_lanes)
        want = np.asarray(jrs.encode_parity(jnp.asarray(data), _ref(field)))
        np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_encode_parity_batch_through_lanes(lanes_on, monkeypatch):
    """The batch moves stripes into lanes: one K11 serves all of them, and
    each stripe equals its own encode with the flag off."""
    batch = rand_field(fields.GF32, (3, 64, 8))
    calls = count_calls(monkeypatch, "ntt_pair_lanes")
    got = rs.encode_parity_batch(batch, fields.GF32, device="cpu")
    assert len(calls) == 1
    monkeypatch.setattr(m, "LANES_PAIR_ENABLED", False)
    for i in range(3):
        assert torch.equal(got[i], rs.encode_parity(batch[i], fields.GF32,
                                                    device="cpu"))


def test_encode_blocks_gf16_through_lanes(lanes_on, monkeypatch):
    """GF16 encode_blocks with the flag on takes K12 and gives the
    reference's bytes and its parts form."""
    k, raw, pairs = _wire16_case()
    calls = count_calls(monkeypatch, "ntt_pair_lanes_wire16")
    got = rs.encode_blocks(raw, GF16, device="cpu")
    assert len(calls) == 1
    want = np.asarray(jrs.encode_blocks(jnp.asarray(raw), jfields.GF16))
    np.testing.assert_array_equal(got.numpy(), want)
    st, bm = rs.encode_blocks_gf16_parts(pairs, device="cpu")
    st_ref, bm_ref = jrs.encode_blocks_gf16_parts(jnp.asarray(pairs),
                                                  interpret=True)
    np.testing.assert_array_equal(to_numpy_u32(st), np.asarray(st_ref))
    np.testing.assert_array_equal(to_numpy_u32(bm), np.asarray(bm_ref))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_wire_decode_through_lanes(field, lanes_on, monkeypatch):
    """decode_data_from_parity and decode_wire_parts run the pair with the
    inverse coset seed: through K11 with the flag on, equal to the
    reference's and to the raw blocks."""
    k = 1 << 6
    n = 2 * k
    raw = np.random.default_rng(5).integers(0, 256, (k, 512), dtype=np.uint8)
    parity = np.asarray(jrs.encode_blocks(jnp.asarray(raw), _ref(field)))
    pairs = np.array(parity).view(np.uint32)
    calls = count_calls(monkeypatch, "ntt_pair_lanes")
    got = decode.decode_wire_parts(pairs, n, k, field, device="cpu")
    assert len(calls) == 1
    np.testing.assert_array_equal(to_numpy_u32(got),
                                  np.ascontiguousarray(raw).view(np.uint32))
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(
        jdec.decode_wire_parts(jnp.asarray(pairs), n, k, _ref(field))))
    par = rand_field(field, (k, 6))
    np.testing.assert_array_equal(
        to_numpy_u32(decode.decode_data_from_parity(par, field, n,
                                                    device="cpu")),
        np.asarray(jdec.decode_data_from_parity(jnp.asarray(par),
                                                _ref(field), n)))


def test_pair_mid_table_matches_reference():
    for field in FIELDS:
        for k, g in ((32, 3), (1 << 13, field.root_of_order(1 << 14))):
            np.testing.assert_array_equal(
                m._pair_mid_table(field.name, k, g),
                jmfa._pair_mid_table(field.name, k, g))
