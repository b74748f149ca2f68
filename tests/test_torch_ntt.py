"""Port vs reference: host tables and the plain transforms
(fastecc_tpu_torch.ntt vs fastecc_tpu.ntt), on the CPU, exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastecc_tpu import ntt as jntt
from fastecc_tpu import fields as jfields
from fastecc_tpu_torch import fields, ntt
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32

torch.set_num_threads(1)

RNG = np.random.default_rng(0x0177)
FIELDS = [fields.GF32, fields.GF16]


def rand_field(field, shape):
    return RNG.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _ref(field):
    return jfields.FIELDS[field.name]


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_host_tables_match_reference(field):
    rf = _ref(field)
    w = field.root_of_order(1 << 10)
    np.testing.assert_array_equal(ntt.powers_host(field, w, 777),
                                  jntt.powers_host(rf, w, 777))
    bases = rand_field(field, (9,))
    np.testing.assert_array_equal(ntt.powers_outer_host(field, bases, 33),
                                  jntt.powers_outer_host(rf, bases, 33))
    vals = rand_field(field, (500,))
    np.testing.assert_array_equal(ntt.prepare_consts(field, vals),
                                  jntt.prepare_consts(rf, vals))
    for a in (2, 4, 8, 64, 1 << 10):
        for inv in (False, True):
            np.testing.assert_array_equal(
                ntt._stage_twiddles(field.name, a, inv),
                jntt._stage_twiddles(field.name, a, inv))
            if a >= 4:
                for mine, theirs in zip(
                        ntt._r4_twiddles(field.name, a, inv),
                        jntt._r4_twiddles(field.name, a, inv)):
                    np.testing.assert_array_equal(mine, theirs)
    for n, c in ((1 << 8, 16), (1 << 10, 64), (1 << 10, 8)):
        for inv in (False, True):
            np.testing.assert_array_equal(
                ntt._four_step_twiddles(field.name, n, c, inv),
                jntt._four_step_twiddles(field.name, n, c, inv))
    g = field.root_of_order(1 << 9)
    np.testing.assert_array_equal(ntt._pre_powers(field.name, g, 256),
                                  jntt._pre_powers(field.name, g, 256))


def test_gf16_stage_table_assert():
    bad = np.array([1, 0x10000], dtype=np.uint32)
    with pytest.raises(AssertionError):
        ntt._assert_gf16_stage_table(fields.GF16, bad)
    ntt._assert_gf16_stage_table(fields.GF32, bad)   # GF32: no contract


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("n", [2, 8, 32, 256, 1 << 10])
@pytest.mark.parametrize("radix", [2, 4])
def test_stockham_matches_reference(field, n, radix):
    x = rand_field(field, (n, 3))
    tx = from_numpy_u32(x, "cpu")
    for inv in (False, True):
        want = np.asarray(jntt.ntt(jnp.asarray(x), _ref(field), inverse=inv,
                                   radix=radix))
        got = to_numpy_u32(ntt.ntt(tx, field, inverse=inv, radix=radix))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        to_numpy_u32(ntt.intt(tx, field, scale=False)),
        np.asarray(jntt.intt(jnp.asarray(x), _ref(field), scale=False)))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("c_dim", [None, 4, 64])
def test_four_step_matches_reference(field, c_dim):
    x = rand_field(field, (1 << 8, 2, 3))       # two trailing lane axes
    for inv in (False, True):
        want = np.asarray(jntt.ntt_four_step(jnp.asarray(x), _ref(field),
                                             inverse=inv, c_dim=c_dim))
        got = to_numpy_u32(ntt.ntt_four_step(from_numpy_u32(x, "cpu"), field,
                                             inverse=inv, c_dim=c_dim))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("n", [1, 2, 4, 128, 1 << 10])
def test_ntt_auto_matches_reference(field, n):
    """ntt_auto on a CPU tensor: the plain versions of the fused passes,
    including the fused pre_seed multiply and the unscaled inverse."""
    x = rand_field(field, (n, 5))
    tx = from_numpy_u32(x, "cpu")
    g = field.root_of_order(max(2 * n, 2))
    for kw in ({}, {"inverse": True}, {"inverse": True, "scale": False},
               {"pre_seed": g}, {"inverse": True, "pre_seed": 3}):
        want = np.asarray(jntt.ntt_auto(jnp.asarray(x), _ref(field), **kw))
        got = to_numpy_u32(ntt.ntt_auto(tx, field, **kw))
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


def test_ntt_auto_lane_axes_and_numpy_input():
    x = rand_field(fields.GF32, (64, 2, 3))
    got = ntt.ntt_auto(x, fields.GF32, device="cpu")
    assert got.dtype == torch.uint32 and tuple(got.shape) == (64, 2, 3)
    np.testing.assert_array_equal(
        to_numpy_u32(got), np.asarray(jntt.ntt(jnp.asarray(x), jfields.GF32)))


def test_ntt_auto_decode_fusions_not_ported():
    """The decode fusions, once missing here, now run (K5, K7, K7-sel):
    ntt_auto with pre_vec / post_vec / sel_* == the reference's in both
    fields, and the contracts the reference asserts raise ValueError."""
    n = 1 << 5
    mask = (np.arange(n) % 3 == 0).astype(np.uint32)
    for field in FIELDS:
        x = rand_field(field, (n, 3))
        v = rand_field(field, (2, n))
        orig = rand_field(field, (n, 3))
        tx = from_numpy_u32(x, "cpu")
        for kw in ({"pre_vec": v[0]}, {"inverse": True, "post_vec": v[1]},
                   {"pre_vec": v[0], "post_vec": v[1], "sel_mask": mask,
                    "sel_orig": orig}):
            want = np.asarray(jntt.ntt_auto(
                jnp.asarray(x), _ref(field),
                **{k: jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for k, a in kw.items()}))
            got = to_numpy_u32(ntt.ntt_auto(tx, field, **kw))
            np.testing.assert_array_equal(got, want, err_msg=str(list(kw)))
    with pytest.raises(ValueError, match="requires post_vec"):
        ntt.ntt_auto(tx, field, sel_mask=mask, sel_orig=x)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ntt.ntt_auto(tx, field, pre_seed=3, pre_vec=v[0])


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_host_oracles_match_reference(field):
    x = rand_field(field, (32, 2))
    for inv in (False, True):
        np.testing.assert_array_equal(
            ntt.ntt_host(x, field, inverse=inv),
            jntt.ntt_host(x, _ref(field), inverse=inv))
        np.testing.assert_array_equal(
            ntt.naive_dft(x, field, inverse=inv),
            jntt.naive_dft(x, _ref(field), inverse=inv))
    np.testing.assert_array_equal(
        to_numpy_u32(ntt.ntt(from_numpy_u32(x, "cpu"), field)),
        ntt.naive_dft(x, field))
