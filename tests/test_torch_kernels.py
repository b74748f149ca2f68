"""Port vs reference: the fused passes K1-K7 (fastecc_tpu_torch.kernels.
ntt_mfa) against the Pallas kernels they replace.

On the CPU each wrapper runs its plain version; the JAX side runs the
Pallas kernels in interpret mode, as tests/test_pallas.py does. The CUDA
kernels themselves are compared with the plain versions by
tests/test_torch_cuda.py (skipped without a card) and by
``chip_smoke.py`` on the H100.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastecc_tpu import fields as jfields
from fastecc_tpu.kernels import ntt_mfa as jmfa
from fastecc_tpu.ntt import ntt as jntt_staged
from fastecc_tpu_torch import fields
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
from fastecc_tpu_torch.kernels import _build
from fastecc_tpu_torch.kernels import ntt_mfa as m

torch.set_num_threads(1)

RNG = np.random.default_rng(0xC0DA)
FIELDS = [fields.GF32, fields.GF16]


def rand_field(field, shape):
    return RNG.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)


def rand_tables(field, n):
    """Prepared [n] tables (v1, v2, post) and a mask with about half its
    rows set. GF16 tables hold 0x10000 (p - 1) at some rows, as the
    decode's l(w^j) and inv(x l') can."""
    vecs = [rand_field(field, n) for _ in range(3)]
    if not field.use_mont:
        for v in vecs:
            v[RNG.choice(n, size=n // 8, replace=False)] = 0x10000
    mask = (RNG.random(n) < 0.5).astype(np.uint32)
    return vecs, mask


def _ref(field):
    return jfields.FIELDS[field.name]


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("n", [1 << 7, 1 << 8, 1 << 10])
def test_passes_match_pallas_interpret(field, n):
    """K1+K3 (forward and scaled inverse), K4+K3 (pre_seed) and
    K1+K2+K3 (the coset pair) vs ntt_pallas / ntt_coset_pair_pallas in
    interpret mode, 128 lanes."""
    x = rand_field(field, (n, 128))
    jx, tx = jnp.asarray(x), from_numpy_u32(x, "cpu")
    g = field.root_of_order(2 * n)
    rf = _ref(field)
    want = np.asarray(jmfa.ntt_pallas(jx, rf, interpret=True))
    np.testing.assert_array_equal(to_numpy_u32(m.ntt_fused(tx, field)), want)
    want = np.asarray(jmfa.ntt_pallas(jx, rf, pre_seed=g, interpret=True))
    np.testing.assert_array_equal(
        to_numpy_u32(m.ntt_fused(tx, field, pre_seed=g)), want)
    want = np.asarray(jmfa.ntt_coset_pair_pallas(jx, rf, g, interpret=True,
                                                 tile=(8, 128)))
    np.testing.assert_array_equal(
        to_numpy_u32(m.ntt_coset_pair(tx, field, g)), want)
    if n == 1 << 8:
        want = np.asarray(jmfa.ntt_pallas(jx, rf, inverse=True,
                                          interpret=True))
        np.testing.assert_array_equal(
            to_numpy_u32(m.ntt_fused(tx, field, inverse=True)), want)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("n", [1 << 7, 1 << 8, 1 << 10])
def test_decode_fusions_match_pallas_interpret(field, n):
    """K5+K7 and K5+K7-sel (ntt_fused with pre_vec/post_vec/sel_*) vs
    ntt_pallas, and the decode pair K5 -> K6 -> K7-sel / K7 (ntt_pair,
    merge on and off) vs ntt_pair_pallas, in interpret mode, 128 lanes."""
    x = rand_field(field, (n, 128))
    orig = rand_field(field, (n, 128))
    (v1, v2, post), mask = rand_tables(field, n)
    rf = _ref(field)
    j = {k: jnp.asarray(a) for k, a in
         dict(x=x, orig=orig, v1=v1, v2=v2, post=post, mask=mask).items()}
    t = {k: from_numpy_u32(np.asarray(a), "cpu") for k, a in j.items()}
    inv = n == 1 << 8
    want = np.asarray(jmfa.ntt_pallas(j["x"], rf, inverse=inv,
                                      pre_vec=j["v1"], post_vec=j["post"],
                                      interpret=True))
    np.testing.assert_array_equal(to_numpy_u32(m.ntt_fused(
        t["x"], field, inverse=inv, pre_vec=t["v1"], post_vec=t["post"])),
        want)
    want = np.asarray(jmfa.ntt_pallas(j["x"], rf, pre_vec=j["v1"],
                                      post_vec=j["post"], sel_mask=j["mask"],
                                      sel_orig=j["orig"], interpret=True))
    got = to_numpy_u32(m.ntt_fused(t["x"], field, pre_vec=t["v1"],
                                   post_vec=t["post"], sel_mask=t["mask"],
                                   sel_orig=t["orig"]))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[mask == 0], orig[mask == 0])
    for merge in (False, True):
        sel = dict(sel_mask=j["mask"], sel_orig=j["x"]) if merge else {}
        want = np.asarray(jmfa.ntt_pair_pallas(
            j["x"], rf, pre_vec1=j["v1"], pre_vec2=j["v2"],
            post_vec=j["post"], interpret=True, tile=(8, 128), **sel))
        sel = dict(sel_mask=t["mask"], sel_orig=t["x"]) if merge else {}
        got = m.ntt_pair(t["x"], field, pre_vec1=t["v1"], pre_vec2=t["v2"],
                         post_vec=t["post"], **sel)
        np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_decode_passes_match_staged_reference(field):
    """Each new pass's plain version at a small split vs the reference's
    staged jnp composition: K5 (table, then pass A), K6 (the seam with a
    table in the middle) and K7-sel (pass B, table, select)."""
    from fastecc_tpu.ntt import mul_prepared as jmul
    n, c, lanes = 1 << 6, 4, 5
    r = n // c
    x = rand_field(field, (n, lanes))
    (v1, v2, post), mask = rand_tables(field, n)
    rf = _ref(field)
    jx = jnp.asarray(x)
    x3 = from_numpy_u32(x, "cpu").reshape(c, r, lanes)
    tv = {k: from_numpy_u32(a, "cpu") for k, a in
          dict(v1=v1, v2=v2, post=post, mask=mask).items()}
    # K5 + K3 is the NTT of v1 * x
    col = m.col_pass_plain(x3, field, pre_vec=tv["v1"])
    want = np.asarray(jntt_staged(jmul(rf, jx, jnp.asarray(v1)[:, None]), rf))
    np.testing.assert_array_equal(
        to_numpy_u32(m.row_pass_plain(col, field)).reshape(n, lanes), want)
    # K1 -> K6 -> K7-sel is the decode pair on the swapped split
    col1 = m.col_pass_plain(x3, field, inverse=True)
    col2 = m.seam_pass_plain(col1, field, pre_vec2=tv["v2"])
    got = m.row_pass_plain(col2, field, post_vec=tv["post"],
                           sel_mask=tv["mask"],
                           sel_orig=x3.reshape(col2.shape))
    coeffs = jntt_staged(jx, rf, inverse=True)
    y = jmul(rf, jntt_staged(jmul(rf, coeffs, jnp.asarray(v2)[:, None]), rf),
             jnp.asarray(post)[:, None])
    want = np.where(mask[:, None] != 0, np.asarray(y), x)
    np.testing.assert_array_equal(to_numpy_u32(got).reshape(n, lanes), want)


def test_fusion_contracts_raise_value_error():
    """The reference's asserts on the fusions are ValueErrors here."""
    f = fields.GF32
    x = from_numpy_u32(rand_field(f, (16, 2)), "cpu")
    v = from_numpy_u32(rand_field(f, 16), "cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        m.ntt_fused(x, f, pre_seed=3, pre_vec=v)
    with pytest.raises(ValueError, match="requires post_vec"):
        m.ntt_fused(x, f, sel_mask=v, sel_orig=x)
    with pytest.raises(ValueError, match="go together"):
        m.ntt_fused(x, f, post_vec=v, sel_mask=v)
    with pytest.raises(ValueError, match="exactly one"):
        m.ntt_pair(x, f)
    with pytest.raises(ValueError, match="exactly one"):
        m.ntt_pair(x, f, pre_seed2=3, pre_vec2=v)
    with pytest.raises(ValueError, match="go together"):
        m.row_pass_post(x.reshape(4, 4, 2), f, v, sel_orig=x)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("c_dim", [2, 16, 256])
def test_split_choices_bit_exact(field, c_dim):
    """Every C x R split of the single transform and of the pair gives
    the reference's bits (vs the staged jnp transforms): the plain passes
    on a C x R view, the split the wrappers leave to the port's policy."""
    n = 1 << 9
    r = n // c_dim
    x = rand_field(field, (n, 6))
    x3 = from_numpy_u32(x, "cpu").reshape(c_dim, r, 6)
    rf = _ref(field)
    for inv in (False, True):
        want = np.asarray(jntt_staged(jnp.asarray(x), rf, inverse=inv))
        col = m.col_pass_plain(x3, field, inverse=inv)
        got = to_numpy_u32(m.row_pass_plain(col, field, inverse=inv))
        np.testing.assert_array_equal(got.reshape(n, 6), want)
    g = field.root_of_order(2 * n)
    coeffs = jntt_staged(jnp.asarray(x), rf, inverse=True)
    pre = jnp.asarray(m.prepare_consts(
        field, m.powers_host(field, g, n))).reshape(n, 1)
    from fastecc_tpu.ntt import mul_prepared as jmul
    want = np.asarray(jntt_staged(jmul(rf, coeffs, pre), rf))
    col1 = m.col_pass_plain(x3, field, inverse=True)
    got = m.row_pass_plain(m.seam_pass_plain(col1, field, g), field)
    np.testing.assert_array_equal(to_numpy_u32(got).reshape(n, 6), want)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_table_builders_match_reference(field):
    for c in (2, 8, 32, 1 << 10):
        for inv in (False, True):
            np.testing.assert_array_equal(
                m._packed_stage_twiddles(field.name, c, inv),
                jmfa._packed_stage_twiddles(field.name, c, inv))
            np.testing.assert_array_equal(
                m._packed_w3_twiddles(field.name, c, inv),
                jmfa._packed_w3_twiddles(field.name, c, inv))
    for n, c, tr in ((1 << 10, 32, 8), (1 << 12, 64, 4), (1 << 8, 16, 16)):
        for inv, scale in ((False, True), (True, True), (True, False)):
            for mine, theirs in zip(
                    m._colpass_seeds(field.name, n, c, inv, scale, tr),
                    jmfa._colpass_seeds(field.name, n, c, inv, scale, tr)):
                np.testing.assert_array_equal(mine, theirs)
    g = field.root_of_order(1 << 11)
    for mine, theirs in zip(m._pre_mul_tables(field.name, g, 32, 64, 8),
                            jmfa._pre_mul_tables(field.name, g, 32, 64, 8)):
        np.testing.assert_array_equal(mine, theirs)


def test_split_policy_fits_shared_memory():
    """The port's splits keep every pass length <= 1024 up to 2^20, and
    the pair keeps its swapped-split seam (c2 = r1, r2 = c1)."""
    for t in range(2, 21):
        n = 1 << t
        c = m._split(n)
        c1 = m._pair_split(n)
        assert c * (n // c) == n and c1 * (n // c1) == n
        assert max(c, n // c, c1, n // c1) <= 1024
        assert min(c, n // c, c1, n // c1) >= 2
    assert (m._pair_split(1 << 19), (1 << 19) // m._pair_split(1 << 19)) == (
        512, 1024)
    assert m._split(1 << 20) == 1024 == m.MAX_PASS_LEN


def test_wrappers_refuse_other_devices():
    x = torch.empty((8, 4, 2), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        m.col_pass(x, fields.GF32)


def test_launch_counts_only_count_launches():
    """Plain versions (CPU tensors) never touch the launch counts."""
    m.reset_launches()
    x = from_numpy_u32(rand_field(fields.GF32, (64, 4)), "cpu")
    v = from_numpy_u32(rand_field(fields.GF32, 64), "cpu")
    m.ntt_coset_pair(x, fields.GF32, fields.GF32.root_of_order(128))
    m.ntt_fused(x, fields.GF32, pre_seed=5)
    m.ntt_fused(x, fields.GF32, pre_vec=v, post_vec=v, sel_mask=v,
                sel_orig=x)
    m.ntt_pair(x, fields.GF32, pre_vec1=v, pre_vec2=v, post_vec=v)
    m.ntt_coset_pair_wire16(x[:, :0].new_zeros((64, 8)), fields.GF16,
                            fields.GF16.root_of_order(128))
    m.ntt_pair_lanes(x, fields.GF32, fields.GF32.root_of_order(128))
    m.ntt_pair_lanes_wire16(x[:, :0].new_zeros((64, 8)), fields.GF16,
                            fields.GF16.root_of_order(128))
    assert len(m.LAUNCHES) == 13 and set(m.LAUNCHES.values()) == {0}


def test_ctypes_signatures_match_c_entries():
    """Each C entry in the CUDA sources has as many parameters as its
    ctypes argtypes, with ints and pointers in the same places."""
    src = "".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    for name, argtypes in _build.SIGNATURES.items():
        sig = re.search(rf"int {name}\(([^)]*)\)", src)
        assert sig, name
        params = [p.strip() for p in sig.group(1).split(",")]
        assert len(params) == len(argtypes), name
        for p, at in zip(params, argtypes):
            is_int = p.startswith("int ")
            assert is_int == (at is _build.ctypes.c_int), (name, p)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build names what is missing (no silent CPU path)."""
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
