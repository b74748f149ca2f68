"""Port vs reference: the fused passes K1-K4 (fastecc_tpu_torch.kernels.
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
    m.ntt_coset_pair(x, fields.GF32, fields.GF32.root_of_order(128))
    m.ntt_fused(x, fields.GF32, pre_seed=5)
    assert set(m.LAUNCHES.values()) == {0}


def test_ctypes_signatures_match_c_entries():
    """Each C entry in ntt_mfa.cu has as many parameters as its ctypes
    argtypes, with ints and pointers in the same places."""
    src = (_build.CSRC / "ntt_mfa.cu").read_text()
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
