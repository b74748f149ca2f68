"""Port vs reference: GF(p) arithmetic (fastecc_tpu_torch.gf vs
fastecc_tpu.gf) and the copied field constants.

Same numpy inputs through both packages on the CPU; every comparison is
exact (tolerance 0: the codec is integer arithmetic).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastecc_tpu import gf as jgf
from fastecc_tpu import fields as jfields
from fastecc_tpu_torch import fields, gf
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32

torch.set_num_threads(1)

RNG = np.random.default_rng(0x7A5C)
FIELDS = [fields.GF32, fields.GF16]


def _ref(field):
    return jfields.FIELDS[field.name]


def edge_elems(field):
    vals = [0, 1, 2, field.p - 1, field.p - 2, field.p // 2,
            (1 << 16) - 1, 1 << 16, (1 << 16) + 1]
    if field.use_mont:
        vals += [field.r_mod_p, field.r2_mod_p, 1 << 31,
                 (1 << 32) - (1 << 20)]
    return np.array([v % field.p for v in vals], dtype=np.uint32)


def pairs(field, n=4000):
    e = edge_elems(field)
    a = np.concatenate([RNG.integers(0, field.p, n, dtype=np.uint64)
                        .astype(np.uint32), np.repeat(e, len(e))])
    b = np.concatenate([RNG.integers(0, field.p, n, dtype=np.uint64)
                        .astype(np.uint32), np.tile(e, len(e))])
    return a, b


def t(a):
    return from_numpy_u32(a, "cpu")


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_reference(field, op):
    a, b = pairs(field)
    got = to_numpy_u32(getattr(gf, op)(field, t(a), t(b)))
    want = np.asarray(getattr(jgf, op)(_ref(field), jnp.asarray(a),
                                       jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    oracle = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
              "mul": lambda x, y: x * y}[op]
    np.testing.assert_array_equal(
        got.astype(object), oracle(a.astype(object), b.astype(object))
        % field.p)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_neg_and_mul_const(field):
    a, _ = pairs(field)
    np.testing.assert_array_equal(
        to_numpy_u32(gf.neg(field, t(a))),
        np.asarray(jgf.neg(_ref(field), jnp.asarray(a))))
    for c in (0, 1, field.p - 1, 0x10000, 12345):
        np.testing.assert_array_equal(
            to_numpy_u32(gf.mul_const(field, t(a), c)),
            np.asarray(jgf.mul_const(_ref(field), jnp.asarray(a), c)))


def test_mul_wide_matches_reference():
    a, b = pairs(fields.GF32)
    hi, lo = gf._mul_wide(t(a), t(b))
    jhi, jlo = jgf._mul_wide(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(to_numpy_u32(hi), np.asarray(jhi))
    np.testing.assert_array_equal(to_numpy_u32(lo), np.asarray(jlo))
    full = a.astype(object) * b.astype(object)
    np.testing.assert_array_equal(
        to_numpy_u32(hi).astype(object) * (1 << 32)
        + to_numpy_u32(lo).astype(object), full)


@pytest.mark.parametrize("generic", [False, True], ids=["solinas", "generic"])
def test_mont_mul_matches_reference(generic):
    a, b = pairs(fields.GF32)
    got = to_numpy_u32(gf.mont_mul(fields.GF32, t(a), t(b), generic=generic))
    want = np.asarray(jgf.mont_mul(jfields.GF32, jnp.asarray(a),
                                   jnp.asarray(b), generic=generic))
    np.testing.assert_array_equal(got, want)


def test_generic_redc_non_solinas_prime():
    """The generic REDC branch on another Montgomery prime (3*2^30 + 1),
    against a bigint oracle."""
    p = 3 * (1 << 30) + 1
    field = fields.FieldSpec(
        name="GF_P3", p=p, bits=32, g=5, max_log2=30, use_mont=True,
        r_mod_p=(1 << 32) % p, r2_mod_p=(1 << 64) % p,
        n_prime=(-pow(p, -1, 1 << 32)) % (1 << 32))
    a = RNG.integers(0, p, 5000, dtype=np.uint64).astype(np.uint32)
    b = RNG.integers(0, p, 5000, dtype=np.uint64).astype(np.uint32)
    got = to_numpy_u32(gf.mont_mul(field, t(a), t(b)))
    rinv = pow(1 << 32, p - 2, p)
    assert (got.astype(object)
            == a.astype(object) * b.astype(object) * rinv % p).all()


def test_mont_roundtrip():
    a, _ = pairs(fields.GF32)
    am = gf.to_mont(fields.GF32, t(a))
    np.testing.assert_array_equal(
        to_numpy_u32(am), np.asarray(jgf.to_mont(jfields.GF32,
                                                  jnp.asarray(a))))
    np.testing.assert_array_equal(to_numpy_u32(gf.from_mont(fields.GF32, am)),
                                  a)


def test_gf16_multiplies_match_reference():
    """_mul_gf16 over the full domain (0x10000 included) and the
    escape-free _mul_gf16_tw for b < 2^16."""
    e = np.array([0, 1, 2, 0xFFFF, 0x10000], dtype=np.uint32)
    a = np.concatenate([e.repeat(5), RNG.integers(0, 0x10001, 4096,
                                                  dtype=np.uint32)])
    b = np.concatenate([np.tile(e, 5), RNG.integers(0, 0x10001, 4096,
                                                    dtype=np.uint32)])
    np.testing.assert_array_equal(
        to_numpy_u32(gf._mul_gf16(t(a), t(b))),
        np.asarray(jgf._mul_gf16(jnp.asarray(a), jnp.asarray(b))))
    bt = np.where(b == 0x10000, 0xFFFF, b).astype(np.uint32)
    np.testing.assert_array_equal(
        to_numpy_u32(gf._mul_gf16_tw(t(a), t(bt))),
        np.asarray(jgf._mul_gf16_tw(jnp.asarray(a), jnp.asarray(bt))))


def test_carriers_preserve_dtype():
    """u32 in -> u32 out; int64 carriers in -> carriers out."""
    a = t(np.array([1, 2, fields.GF32.p - 1], dtype=np.uint32))
    assert gf.add(fields.GF32, a, a).dtype == torch.uint32
    w = gf.widen(a)
    assert w.dtype == torch.int64
    assert gf.mont_mul(fields.GF32, w, w).dtype == torch.int64
    assert torch.equal(gf.narrow(w), a)


def test_field_constants_match_reference():
    for name, f in fields.FIELDS.items():
        ref = jfields.FIELDS[name]
        for attr in ("p", "bits", "g", "max_log2", "use_mont", "r_mod_p",
                     "r2_mod_p", "n_prime"):
            assert getattr(f, attr) == getattr(ref, attr), (name, attr)
        for lg in range(f.max_log2 + 1):
            assert f.root_of_order(1 << lg) == ref.root_of_order(1 << lg)


def extras_elems(field):
    """0, 1, p-1, p-2 and 0x10000 (p-1 itself in GF16) plus random."""
    e = np.array([0, 1, field.p - 1, field.p - 2, 0x10000 % field.p],
                 dtype=np.uint32)
    return np.concatenate([e, RNG.integers(0, field.p, 500, dtype=np.uint64)
                           .astype(np.uint32)])


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("e", [0, 1, 2, 7, -1, -3, 1 << 20])
def test_pow_const_matches_reference(field, e):
    a = extras_elems(field)
    e = {1 << 20: field.p - 1}.get(e, e)   # p-1: 0 stays 0, others go to 1
    got = to_numpy_u32(gf.pow_const(field, t(a), e))
    np.testing.assert_array_equal(
        got, np.asarray(jgf.pow_const(_ref(field), jnp.asarray(a), e)))
    np.testing.assert_array_equal(
        got.astype(object),
        [pow(int(v), e, field.p) if v else (1 if e == 0 else 0) for v in a])


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_inv_matches_reference(field):
    a = extras_elems(field)
    got = to_numpy_u32(gf.inv(field, t(a)))
    np.testing.assert_array_equal(
        got, np.asarray(jgf.inv(_ref(field), jnp.asarray(a))))
    assert got[0] == 0                                   # inv(0) = 0
    np.testing.assert_array_equal(
        got[1:].astype(object) * a[1:].astype(object) % field.p, 1)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_pow_base_matches_reference(field):
    w = field.root_of_order(1 << 10)
    e = np.concatenate([np.array([0, 1, (1 << 10) - 1, 1 << 10,
                                  (1 << field.max_log2) - 1], np.uint32),
                        RNG.integers(0, 1 << field.max_log2, 300,
                                     dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(jgf.pow_base(_ref(field), w, jnp.asarray(e)))
    np.testing.assert_array_equal(to_numpy_u32(gf.pow_base(field, w, t(e))),
                                  want)
    carried = gf.pow_base(field, w, torch.from_numpy(e.astype(np.int64)))
    assert carried.dtype == torch.int64
    np.testing.assert_array_equal(carried.numpy(), want)
    np.testing.assert_array_equal(
        want.astype(object), [pow(w, int(v), field.p) for v in e])


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_prepare_device_and_mul_prepared_device(field):
    a, b = pairs(field)
    a = np.concatenate([a, extras_elems(field)])
    b = np.concatenate([b, extras_elems(field)[::-1]])
    rf = _ref(field)
    prep = gf.prepare_device(field, t(b))
    np.testing.assert_array_equal(
        to_numpy_u32(prep), np.asarray(jgf.prepare_device(rf, jnp.asarray(b))))
    got = to_numpy_u32(gf.mul_prepared_device(field, t(a), prep))
    np.testing.assert_array_equal(got, np.asarray(jgf.mul_prepared_device(
        rf, jnp.asarray(a), jgf.prepare_device(rf, jnp.asarray(b)))))
    np.testing.assert_array_equal(
        got.astype(object), a.astype(object) * b.astype(object) % field.p)
