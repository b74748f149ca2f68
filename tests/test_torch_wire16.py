"""Port vs reference: the GF16 wire pair (K8 -> K9 -> K10) and the GF16
wire encode (fastecc_tpu_torch.rs / kernels.ntt_mfa vs fastecc_tpu.rs /
kernels.ntt_mfa).

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

from fastecc_tpu import fields as jfields
from fastecc_tpu import rs as jrs
from fastecc_tpu.kernels import ntt_mfa as jmfa
from fastecc_tpu_torch import decode, fields, ntt, packing, rs
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
from fastecc_tpu_torch.kernels import ntt_mfa as m

torch.set_num_threads(1)

GF16 = fields.GF16
JGF16 = jfields.GF16
RNG = np.random.default_rng(0x16A1)


def raw_blocks(k, block_bytes, rng=RNG):
    return rng.integers(0, 256, (k, block_bytes), dtype=np.uint8)


def pairs_of(raw):
    return np.ascontiguousarray(raw).view(np.uint32)


def port_pair(raw):
    k = raw.shape[0]
    return m.ntt_coset_pair_wire16(from_numpy_u32(pairs_of(raw), "cpu"),
                                   GF16, GF16.root_of_order(2 * k))


def ref_pair(raw):
    k = raw.shape[0]
    st, bm = jmfa.ntt_coset_pair_wire16_pallas(
        jnp.asarray(pairs_of(raw)), JGF16, GF16.root_of_order(2 * k),
        interpret=True, tile=(8, 128))
    return np.asarray(st), np.asarray(bm)


@pytest.mark.parametrize("k,block_bytes", [(1 << 8, 1024), (1 << 7, 4096)])
def test_wire16_pair_matches_pallas(k, block_bytes):
    """ntt_coset_pair_wire16 (stored and bitmap) vs
    ntt_coset_pair_wire16_pallas in interpret mode, and the assembled
    wire bytes vs the reference's wire_gf16_from_parts."""
    raw = raw_blocks(k, block_bytes)
    st, bm = port_pair(raw)
    st_ref, bm_ref = ref_pair(raw)
    np.testing.assert_array_equal(to_numpy_u32(st), st_ref)
    np.testing.assert_array_equal(to_numpy_u32(bm), bm_ref)
    wire = rs.wire_gf16_from_parts(st, bm)
    assert wire.dtype == torch.uint8 and wire.device.type == "cpu"
    np.testing.assert_array_equal(wire.numpy(),
                                  jrs.wire_gf16_from_parts(st_ref, bm_ref))


def test_wire16_pair_escape_case():
    """k = 2^8, B = 4096 under default_rng(0): the parity holds 0x10000
    values (10 of them), so the truncation and the bitmap carry real
    escapes."""
    raw = raw_blocks(1 << 8, 4096, np.random.default_rng(0))
    st, bm = port_pair(raw)
    st_ref, bm_ref = ref_pair(raw)
    np.testing.assert_array_equal(to_numpy_u32(st), st_ref)
    np.testing.assert_array_equal(to_numpy_u32(bm), bm_ref)
    bits = sum(bin(int(w)).count("1") for w in to_numpy_u32(bm).ravel())
    par = np.asarray(jrs.encode_parity(
        jnp.asarray(np.ascontiguousarray(raw).view("<u2").astype(np.uint32)),
        JGF16))
    assert bits == int((par == 0x10000).sum()) == 10


def _dense_escape_case(r2, c2, wu, seed=7):
    """tests/test_pallas.py's adversarial K10 inputs: transform outputs
    ~90% 0x10000 in each half, so bitmap groups carry many bits at once,
    saturated 0xFFFF words among them. Returns (lo2, hi2, stored, bitmap)
    as numpy u32."""
    rng = np.random.default_rng(seed)
    k = r2 * c2

    def half():
        vals = rng.integers(0, 0x10000, (r2, c2, wu)).astype(np.uint32)
        want = np.where(rng.random((r2, c2, wu)) < 0.9, np.uint32(0x10000),
                        vals)
        pre = ntt.ntt_host(want.reshape(r2, c2 * wu), GF16, inverse=True)
        return want.reshape(k, wu), pre.reshape(r2, c2, wu)

    want_lo, lo2 = half()
    want_hi, hi2 = half()
    st = (want_lo & 0xFFFF) | ((want_hi & 0xFFFF) << np.uint32(16))
    sh = (2 * np.arange(8)).astype(np.uint32)
    bm = (((want_lo >> 16).reshape(k, wu // 8, 8) << sh)
          | ((want_hi >> 16).reshape(k, wu // 8, 8) << (sh + 1))).sum(
              axis=-1).astype(np.uint32)
    assert (bm == 0xFFFF).any(), "case no longer hits saturated groups"
    return lo2, hi2, st, bm


def test_wire16_pass_b2_dense_escapes():
    """K10 on its own vs the reference's wire16_pass_b2 in interpret mode
    and vs the expected parts."""
    lo2, hi2, st_want, bm_want = _dense_escape_case(16, 16, 256)
    st, bm = m.wire16_pass_b2(from_numpy_u32(lo2, "cpu"),
                              from_numpy_u32(hi2, "cpu"), GF16)
    st_ref, bm_ref = jmfa.wire16_pass_b2(jnp.asarray(lo2), jnp.asarray(hi2),
                                         JGF16, interpret=True, tile=(8, 128))
    for got, ref, want in ((st, st_ref, st_want), (bm, bm_ref, bm_want)):
        np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(ref))
        np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.mark.parametrize("k,block_bytes,n_mult", [
    (1 << 8, 1024, 2), (1 << 8, 4096, 2),   # the wire pair
    (16, 100, 2),                           # Wu = 25: outside the gate
    (16, 514, 2),                           # B % 4 == 2: outside the gate
    (16, 1024, 4),                          # rate 1/4: the generic route
])
def test_encode_blocks_gf16_matches_reference(k, block_bytes, n_mult,
                                              monkeypatch):
    """encode_blocks(GF16) vs the reference's generic route and, where the
    wire pair runs, its fused branch body in interpret mode. The route
    follows from the shape alone."""
    raw = raw_blocks(k, block_bytes, np.random.default_rng(0))
    pair_calls = []
    real = m.ntt_coset_pair_wire16
    monkeypatch.setattr(m, "ntt_coset_pair_wire16",
                        lambda *a: pair_calls.append(1) or real(*a))
    got = rs.encode_blocks(raw, GF16, n_mult * k, device="cpu")
    fused = n_mult == 2 and block_bytes % 4 == 0 and (block_bytes // 4) % 8 == 0
    assert len(pair_calls) == int(fused)
    want = np.asarray(jrs.encode_blocks(jnp.asarray(raw), JGF16, n_mult * k))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[1] == packing.parity_bytes(GF16, block_bytes)
    if fused:
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jrs._encode_blocks_gf16_fused(jnp.asarray(raw), 2 * k,
                                          interpret=True)))


def test_wire_gf16_from_parts_noncontiguous():
    """Any strides in, the same bytes out (tests/test_pallas.py:528):
    Fortran-ordered numpy parts and transposed-stride tensors."""
    rng = np.random.default_rng(3)
    stored = rng.integers(0, 1 << 16, (64, 32), dtype=np.uint32)
    bm = rng.integers(0, 1 << 16, (64, 4), dtype=np.uint32)
    want = jrs.wire_gf16_from_parts(stored, bm)
    got = rs.wire_gf16_from_parts(np.asfortranarray(stored),
                                  np.asfortranarray(bm), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    st_t = from_numpy_u32(stored.T.copy(), "cpu").T
    bm_t = from_numpy_u32(bm.T.copy(), "cpu").T
    assert not st_t.is_contiguous() and not bm_t.is_contiguous()
    np.testing.assert_array_equal(rs.wire_gf16_from_parts(st_t, bm_t).numpy(),
                                  want)


def test_wire16_parity_decodes():
    """Wire parity from the pair decodes through the port's decode_blocks:
    all parity (every data block lost), and a mix of data and parity."""
    k, block_bytes = 1 << 7, 1024
    raw = raw_blocks(k, block_bytes)
    wire = rs.wire_gf16_from_parts(*port_pair(raw)).numpy()
    survivors = {2 * i + 1: wire[i].tobytes() for i in range(k)}
    got = decode.decode_blocks(survivors, 2 * k, k, GF16,
                               block_bytes=block_bytes, device="cpu")
    np.testing.assert_array_equal(got.numpy(), raw)
    mixed = {2 * i + (i % 2): (wire[i] if i % 2 else raw[i]).tobytes()
             for i in range(k)}
    got = decode.decode_blocks(mixed, 2 * k, k, GF16,
                               block_bytes=block_bytes, device="cpu")
    np.testing.assert_array_equal(got.numpy(), raw)


def test_wire16_parts_from_numpy_and_tensors():
    """encode_blocks_gf16_parts takes the numpy u32 view or the tensor
    view of the raw bytes alike, and equals the reference's parts form."""
    k = 1 << 6
    raw = raw_blocks(k, 512)
    st, bm = rs.encode_blocks_gf16_parts(pairs_of(raw), device="cpu")
    st2, bm2 = rs.encode_blocks_gf16_parts(torch.from_numpy(raw).view(
        torch.uint32))
    assert torch.equal(st, st2) and torch.equal(bm, bm2)
    st_ref, bm_ref = jrs.encode_blocks_gf16_parts(jnp.asarray(pairs_of(raw)),
                                                  interpret=True)
    np.testing.assert_array_equal(to_numpy_u32(st), np.asarray(st_ref))
    np.testing.assert_array_equal(to_numpy_u32(bm), np.asarray(bm_ref))


def test_wire16_gate():
    assert m._wire16_supported(1 << 13, 1 << 14)       # the bench shape
    assert m._wire16_supported(4, 8) and m._wire16_supported(1 << 15, 8)
    assert not m._wire16_supported(1 << 13, 100)       # Wu % 8 != 0
    assert not m._wire16_supported(1 << 16, 8)         # beyond GF16's pair
    assert not m._wire16_supported(2, 8)               # below order 4
    assert not m._wire16_supported(24, 8)              # not a power of two


def test_wire16_contracts_raise_value_error():
    """Where the reference asserts, the port raises ValueError."""
    words = from_numpy_u32(np.zeros((8, 16), np.uint32), "cpu")
    with pytest.raises(ValueError, match="rate-1/2"):
        rs.encode_blocks_gf16_parts(words, 32)
    with pytest.raises(ValueError, match="GF16 path"):
        m.ntt_coset_pair_wire16(words, fields.GF32, 3)
    with pytest.raises(ValueError, match="Wu % 8"):
        m.ntt_coset_pair_wire16(words[:, :12], GF16, 3)
    lo = from_numpy_u32(np.zeros((4, 2, 12), np.uint32), "cpu")
    with pytest.raises(ValueError, match="Wu % 8"):
        m.wire16_pass_b2(lo, lo, GF16)
    with pytest.raises(ValueError, match="one \\[R2, C2, Wu\\] shape"):
        m.wire16_pass_b2(lo[:, :, :8].contiguous(), lo[:, :1, :8], GF16)
    with pytest.raises(ValueError, match="GF16 path"):
        m.seam_pass_wire16(lo.reshape(2, 2, 2, 12), fields.GF32, 3)


def test_wire16_plain_passes_are_the_pair_on_each_half():
    """K8/K9/K10's plain versions are K1/K2/K3's on lo and on hi: the
    wire pair's stored words re-pack the field-domain pair's outputs."""
    k, wu = 1 << 6, 16
    pairs = RNG.integers(0, 1 << 32, (k, wu), dtype=np.uint64).astype(
        np.uint32)
    g = GF16.root_of_order(2 * k)
    st, bm = m.ntt_coset_pair_wire16(from_numpy_u32(pairs, "cpu"), GF16, g)
    lo = m.ntt_coset_pair(from_numpy_u32(pairs & 0xFFFF, "cpu"), GF16, g)
    hi = m.ntt_coset_pair(from_numpy_u32(pairs >> 16, "cpu"), GF16, g)
    lo, hi = to_numpy_u32(lo), to_numpy_u32(hi)
    np.testing.assert_array_equal(to_numpy_u32(st),
                                  (lo & 0xFFFF) | ((hi & 0xFFFF) << 16))
    sh = (2 * np.arange(8)).astype(np.uint32)
    want_bm = (((lo >> 16).reshape(k, -1, 8) << sh)
               | ((hi >> 16).reshape(k, -1, 8) << (sh + 1))).sum(-1)
    np.testing.assert_array_equal(to_numpy_u32(bm), want_bm)
