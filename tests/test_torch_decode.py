"""Port vs reference: erasure decode (fastecc_tpu_torch.decode vs
fastecc_tpu.decode).

Same numpy inputs (from a seed) through both packages on the CPU, where
the port's pass wrappers run their plain versions; every comparison is
exact (tolerance 0: the codec is integer arithmetic). The Pallas side of
the decode pair is held to the port's passes by test_torch_kernels.py;
here the JAX entry points run as the JAX package's own tests run them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastecc_tpu import decode as jdec
from fastecc_tpu import fields as jfields
from fastecc_tpu import rs as jrs
from fastecc_tpu_torch import decode as dec
from fastecc_tpu_torch import fields, testing
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
from fastecc_tpu_torch.kernels import ntt_mfa as m

torch.set_num_threads(1)

RNG = np.random.default_rng(0xDEC1)
FIELDS = [fields.GF32, fields.GF16]
SUITE_N, SUITE_K = 64, 32
SUITE = [name for name, _ in testing.adversarial_suite(SUITE_N, SUITE_K)]


def _ref(field):
    return jfields.FIELDS[field.name]


def rand_field(field, shape):
    return RNG.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)


def encode(field, k, n, lanes):
    data = rand_field(field, (k, lanes))
    return np.asarray(jrs.encode_jit(jnp.asarray(data), _ref(field), n))


def t(a):
    return from_numpy_u32(np.asarray(a, np.uint32), "cpu")


def test_testing_patterns_match_reference():
    from fastecc_tpu import testing as jtesting
    for (name, mine), (jname, theirs) in zip(
            testing.adversarial_suite(1 << 8, 1 << 6, seed=3),
            jtesting.adversarial_suite(1 << 8, 1 << 6, seed=3)):
        assert name == jname
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("pattern", SUITE)
def test_decode_matches_reference_on_adversarial_suite(field, pattern):
    """decode, decode_host_prepared and decode_prepared (device- and
    host-built tables, merge on) == the JAX decode_jit == the codeword."""
    erased = dict(testing.adversarial_suite(SUITE_N, SUITE_K))[pattern]
    cw = encode(field, SUITE_K, SUITE_N, 3)
    bad = cw.copy()
    bad[erased] = 0xDEADBEEF % field.p                   # garbage, not 0
    want = np.asarray(jdec.decode_jit(jnp.asarray(bad), jnp.asarray(erased),
                                      _ref(field)))
    np.testing.assert_array_equal(want, cw)
    np.testing.assert_array_equal(
        to_numpy_u32(dec.decode(bad, erased, field, k=SUITE_K,
                                device="cpu")), want)
    np.testing.assert_array_equal(
        to_numpy_u32(dec.decode_host_prepared(bad, erased, field, k=SUITE_K,
                                              device="cpu")), want)
    for locator in ("host", "device"):
        tables = dec.prepare_decode_tables(erased, SUITE_N, field, locator,
                                           device="cpu")
        np.testing.assert_array_equal(
            to_numpy_u32(dec.decode_prepared(t(bad), *tables, field)), want)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_decode_prepared_without_merge(field):
    """merge=False (K7 in place of K7-sel) returns the reference's raw
    Forney product: the recovered rows at erasures."""
    n, k = 1 << 7, 1 << 6
    erased = testing.random_erasures(n, n - k, seed=5)
    cw = encode(field, k, n, 4)
    bad = cw.copy()
    bad[erased] = 7
    rf = _ref(field)
    jt = jdec.prepare_decode_tables(erased, n, rf, locator="host")
    want = np.asarray(jdec.decode_prepared(jnp.asarray(bad), *jt, rf,
                                           merge=False))
    tables = dec.prepare_decode_tables(erased, n, field, "host", device="cpu")
    got = to_numpy_u32(dec.decode_prepared(t(bad), *tables, field,
                                           merge=False))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[erased], cw[erased])


def test_config10_scale():
    """BASELINE.json:10: recover 2^12 lost of 2^13 (lanes thinned to 2),
    through the all-device decode and the prepared decode."""
    field = fields.GF32
    k, n = 1 << 12, 1 << 13
    cw = encode(field, k, n, 2)
    erased = np.sort(RNG.choice(n, size=n - k, replace=False))
    bad = cw.copy()
    bad[erased] = 7
    np.testing.assert_array_equal(
        to_numpy_u32(dec.decode(bad, erased, field, k=k, device="cpu")), cw)
    rf = _ref(field)
    jt = jdec.prepare_decode_tables(erased, n, rf, locator="host")
    want = np.asarray(jdec.decode_prepared_jit(jnp.asarray(bad), *jt, rf))
    np.testing.assert_array_equal(want, cw)
    tables = dec.prepare_decode_tables(erased, n, field, device="cpu")
    for mine, theirs in zip(tables, jt):
        np.testing.assert_array_equal(to_numpy_u32(mine), np.asarray(theirs))
    np.testing.assert_array_equal(
        to_numpy_u32(dec.decode_prepared(t(bad), *tables, field)), want)


def _locator_oracle(erased, n, field):
    """Bigint expansion of prod (x - w^j), constant term first."""
    w = field.root_of_order(n)
    poly = [1]
    for j in erased:
        r = field.pow_host(w, int(j))
        nxt = [0] * (len(poly) + 1)
        for i, c in enumerate(poly):
            nxt[i + 1] = (nxt[i + 1] + c) % field.p
            nxt[i] = (nxt[i] - c * r) % field.p
        poly = nxt
    return np.array(poly, dtype=np.uint32)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("e", [1, 2, 3, 5, 8, 13])
def test_locator_tables_match_reference(field, e):
    """locator_coeffs (vs a bigint expansion), locator_host and the
    device tables vs the JAX package's, for power-of-two and other
    erasure counts."""
    n = 1 << 6
    erased = np.sort(RNG.choice(n, size=e, replace=False))
    rf = _ref(field)
    np.testing.assert_array_equal(
        to_numpy_u32(dec.locator_coeffs(erased, n, field, device="cpu")),
        _locator_oracle(erased, n, field))
    for mine, theirs in zip(dec.locator_host(erased, n, field),
                            jdec.locator_host(erased, n, rf)):
        np.testing.assert_array_equal(mine, theirs)
    want = jdec.prepare_decode_tables_device(
        jnp.asarray(erased, jnp.uint32), n, rf)
    got = dec.prepare_decode_tables_device(erased, n, field, device="cpu")
    for mine, theirs in zip(got, want):
        np.testing.assert_array_equal(to_numpy_u32(mine), np.asarray(theirs))


def _wire_fixture(field, k):
    raw = RNG.integers(0, 256, size=(k, 4096), dtype=np.uint16).astype(
        np.uint8)
    raw[0, :] = 0xFF                                      # escape path
    parity = np.asarray(jrs.encode_blocks_jit(jnp.asarray(raw), _ref(field)))
    return raw, parity


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_decode_blocks_matches_reference(field):
    """Lose 9 data and 7 parity blocks of 16 + 16 and recover; then
    recover from parity alone."""
    k = 16
    n = 2 * k
    raw, parity = _wire_fixture(field, k)
    dpos, ppos = jrs.data_positions(n, k), jrs.parity_positions(n, k)
    lost_d = set(RNG.choice(k, size=9, replace=False).tolist())
    lost_p = set(RNG.choice(k, size=7, replace=False).tolist())
    mixed = {}
    for i in range(k):
        if i not in lost_d:
            mixed[int(dpos[i])] = raw[i].tobytes()
        if i not in lost_p:
            mixed[int(ppos[i])] = parity[i].tobytes()
    only_parity = {int(ppos[i]): parity[i].tobytes() for i in range(k)}
    for surv in (mixed, only_parity):
        want = jdec.decode_blocks(surv, n, k, _ref(field))
        np.testing.assert_array_equal(want, raw)
        got = dec.decode_blocks(surv, n, k, field, device="cpu")
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
    cw, present = dec.survivors_to_codeword(mixed, n, k, field)
    jcw, jpresent = jdec.survivors_to_codeword(mixed, n, k, _ref(field))
    np.testing.assert_array_equal(cw, jcw)
    np.testing.assert_array_equal(present, jpresent)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_wire_decode_matches_reference(field):
    """decode_wire_parity, decode_wire_parts and decode_data_from_parity
    (the coset pair with seed w_n^-1) vs the JAX package, raw bytes to
    raw bytes."""
    k = 16
    n = 2 * k
    raw, parity = _wire_fixture(field, k)
    rf = _ref(field)
    want = np.asarray(jdec.decode_wire_parity_jit(jnp.asarray(parity), n, k,
                                                  rf))
    np.testing.assert_array_equal(want, raw)
    got = dec.decode_wire_parity(torch.from_numpy(parity.copy()), n, k,
                                 field)
    np.testing.assert_array_equal(got.numpy(), want)
    pairs = np.ascontiguousarray(parity).view(np.uint32)
    want = np.asarray(jdec.decode_wire_parts_jit(jnp.asarray(pairs), n, k,
                                                 rf))
    got = to_numpy_u32(dec.decode_wire_parts(pairs, n, k, field,
                                             device="cpu"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.view(np.uint8), raw)
    par = rand_field(field, (k, 6))
    np.testing.assert_array_equal(
        to_numpy_u32(dec.decode_data_from_parity(par, field, n,
                                                 device="cpu")),
        np.asarray(jdec.decode_data_from_parity(jnp.asarray(par), rf, n)))


def test_recoverability_guards_raise_value_error():
    """The reference's asserts are ValueErrors in the port;
    decode_blocks(check=True) runs the consistency check."""
    field, k, n = fields.GF32, 8, 16
    cw = np.zeros((n, 2), np.uint32)
    too_many = np.arange(n - k + 1)
    with pytest.raises(ValueError, match="unrecoverable"):
        dec.decode(cw, too_many, field, k=k, device="cpu")
    with pytest.raises(ValueError, match="unrecoverable"):
        dec.decode_host_prepared(cw, too_many, field, k=k, device="cpu")
    with pytest.raises(ValueError, match="erasures < n"):
        dec.decode(cw, np.arange(n), field, device="cpu")
    with pytest.raises(ValueError, match="locator"):
        dec.prepare_decode_tables([1], n, field, "gpu", device="cpu")
    raw = np.zeros((k, 4096), np.uint8)
    parity = np.asarray(jrs.encode_blocks_jit(jnp.asarray(raw), _ref(field)))
    ppos = jrs.parity_positions(n, k)
    short = {int(ppos[i]): parity[i].tobytes() for i in range(k - 1)}
    with pytest.raises(ValueError, match="unrecoverable"):
        dec.decode_blocks(short, n, k, field, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        dec.survivors_to_codeword({-1: raw[0].tobytes()}, n, k, field)
    with pytest.raises(ValueError, match="bad parity block"):
        dec.survivors_to_codeword({1: raw[0].tobytes()}, n, k, field)
    full = {int(ppos[i]): parity[i].tobytes() for i in range(k)}
    np.testing.assert_array_equal(
        dec.decode_blocks(full, n, k, field, check=True, device="cpu").numpy(),
        raw)
    with pytest.raises(ValueError, match="rate-1/2"):
        dec.decode_data_from_parity(cw, field, 4 * n, device="cpu")


def test_decode_leaves_launch_counts_at_zero_on_cpu():
    """On the CPU every pass takes its plain version: no launch counted."""
    m.reset_launches()
    n, k = 1 << 5, 1 << 4
    erased = testing.random_erasures(n, n - k, seed=1)
    dec.decode(encode(fields.GF32, k, n, 2), erased, fields.GF32,
               device="cpu")
    assert set(m.LAUNCHES.values()) == {0}
