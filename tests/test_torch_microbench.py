"""The port's microbenchmarks (``fastecc_tpu_torch.kernels.microbench``)
against the JAX package's: the same numpy inputs through the reference's
Pallas kernels in interpret mode and through the port's wrappers on the
CPU (their plain versions), compared bit for bit; the tables, keys and
sizes equal the reference's; and the measurement functions default to the
card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fastecc_tpu.fields import FIELDS as REF_FIELDS
from fastecc_tpu.kernels import microbench as ref
from fastecc_tpu.kernels import ntt_mfa as ref_mfa
from fastecc_tpu.utils import profiling as ref_profiling
from fastecc_tpu_torch import fields
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
from fastecc_tpu_torch.kernels import microbench as mb

torch.set_num_threads(1)


def _ref_chain_inputs(rows):
    """tests/test_pallas.py's chain operands."""
    x = (jnp.arange(rows * ref._TL, dtype=jnp.uint32)
         & jnp.uint32(0xFFFF)).reshape(rows, ref._TL)
    z = ((jnp.arange(rows * ref._TL, dtype=jnp.uint32)
          * jnp.uint32(2654435761)) & jnp.uint32(0xFFFF)
         ).reshape(rows, ref._TL) | jnp.uint32(1)
    return x, z


@pytest.mark.parametrize("variant", list(ref._VARIANTS))
def test_chain_matches_reference_kernel(variant):
    """K14's plain version at depth 3 on [512, 128] == the reference's
    _chain_kernel in interpret mode, for every variant."""
    rows = ref._TS
    x, z = _ref_chain_inputs(rows)
    spec = pl.BlockSpec((ref._TS, ref._TL), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    want = pl.pallas_call(
        functools.partial(ref._chain_kernel, variant=variant, depth=3),
        grid=(1,), in_specs=[spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((rows, ref._TL), jnp.uint32),
        interpret=True)(x, z)
    tx = from_numpy_u32(np.array(x), "cpu")
    tz = from_numpy_u32(np.array(z), "cpu")
    np.testing.assert_array_equal(to_numpy_u32(mb.chain(tx, tz, variant, 3)),
                                  np.asarray(want), err_msg=variant)


@pytest.mark.parametrize("field_name,c", [("GF32", 64), ("GF16", 256),
                                          ("GF32", 2)])
def test_fused_chain_matches_reference_kernel(field_name, c):
    """K15's plain version == the reference's _fused_chain_kernel in
    interpret mode: one row tile, depth 2."""
    field, depth, rows_tiles = REF_FIELDS[field_name], 2, 1
    tw = jnp.asarray(ref_mfa._packed_stage_twiddles(field_name, c,
                                                    False))[:, None]
    w3 = jnp.asarray(ref_mfa._packed_w3_twiddles(field_name, c,
                                                 False))[:, None]
    r_rows = rows_tiles * ref_mfa._TR
    x = (jnp.arange(c * r_rows * ref._TL, dtype=jnp.uint32)
         % jnp.uint32(min(field.p, 0x10000))).reshape(c, r_rows, ref._TL)
    vec = pl.BlockSpec((c, 1), lambda i: (0, 0), memory_space=pltpu.VMEM)
    blk = pl.BlockSpec((c, ref_mfa._TR, ref._TL), lambda i: (0, i, 0),
                       memory_space=pltpu.VMEM)
    want = pl.pallas_call(
        functools.partial(ref._fused_chain_kernel, field=field, c=c,
                          depth=depth),
        grid=(rows_tiles,), in_specs=[vec, vec, blk], out_specs=blk,
        out_shape=jax.ShapeDtypeStruct((c, r_rows, ref._TL), jnp.uint32),
        interpret=True)(tw, w3, x)
    tx = mb.fused_inputs(fields.FIELDS[field_name], c, rows_tiles, "cpu")
    np.testing.assert_array_equal(to_numpy_u32(tx), np.asarray(x))
    got = mb.fused_chain(tx, fields.FIELDS[field_name], depth)
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))


def test_inputs_match_reference():
    x, z = _ref_chain_inputs(2 * ref._TS)
    tx, tz = mb.chain_inputs(2 * ref._TS, "cpu")
    np.testing.assert_array_equal(to_numpy_u32(tx), np.asarray(x))
    np.testing.assert_array_equal(to_numpy_u32(tz), np.asarray(z))


def test_tables_equal_reference():
    assert list(mb._VARIANTS) == list(ref._VARIANTS)
    assert mb._BCAST == ref._BCAST
    assert mb._COMPOSITE == ref._COMPOSITE
    assert mb._STAGES_PER_STEP == ref._STAGES_PER_STEP
    assert mb._FUSED_CONFIGS == ref._FUSED_CONFIGS
    assert (mb._TL, mb._TS, mb._TR) == (ref._TL, ref._TS, ref_mfa._TR)
    assert (mb._DEFAULT_DEPTH, mb._COMPOSITE_DEPTH) == (
        ref._DEFAULT_DEPTH, ref._COMPOSITE_DEPTH)
    for v in ref._VARIANTS:
        assert mb.peak_key(v) == ref.peak_key(v)


def test_measure_peaks_keys_equal_reference(monkeypatch):
    """measure_peaks emits the reference's key set (mirroring
    tests/test_pallas.py's key contract), which covers every key of the
    reference's peaks table; the rates are stubbed, the keys are not."""
    monkeypatch.setattr(mb, "hbm_stream_gbps", lambda **kw: 1.0)
    monkeypatch.setattr(mb, "vpu_chain_gops", lambda v, **kw: 2.0)
    monkeypatch.setattr(mb, "fused_stage_gops", lambda **kw: 3.0)
    got = set(mb.measure_peaks(device="cpu"))
    want = ({ref.peak_key(v) for v in ref._VARIANTS} | {"hbm_stream_gbps"}
            | set(ref._FUSED_CONFIGS))
    assert got == want
    assert set(ref_profiling.MEASURED_PEAKS_V5E) <= got


def test_measurements_default_to_the_card():
    """With no GPU and no device="cpu", every measurement raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the calls would run there")
    for fn in (mb.measure_peaks, mb.hbm_stream_gbps, mb.fused_stage_gops,
               lambda: mb.vpu_chain_gops("solinas")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_measurements_run_on_the_cpu_plain_versions():
    """Each measurement runs end to end on the plain versions when asked
    for the CPU (tiny sizes), and no launch is counted."""
    mb.reset_launches()
    assert mb.hbm_stream_gbps(mib=1, iters=1, device="cpu") > 0
    assert mb.vpu_chain_gops("gf16-tw", mib=1, depth=2, iters=1,
                             device="cpu") > 0
    assert mb.fused_stage_gops("GF16", c=16, rows_tiles=1, depth=1,
                               iters=1, device="cpu") > 0
    assert set(mb.LAUNCHES.values()) == {0}


def test_copy_plain_is_a_copy():
    x = from_numpy_u32(np.arange(4099, dtype=np.uint32) * np.uint32(7919),
                       "cpu")
    for view in (x, x[1:], x[:5].reshape(5)):
        out = mb.copy(view)
        assert torch.equal(out, view)
        assert out.data_ptr() != view.data_ptr()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, z = mb.chain_inputs(mb._TS, "cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        mb.chain(x, z, "nope", 1)
    with pytest.raises(ValueError, match="multiple of 512"):
        mb.chain(x[:256], z[:256], "solinas", 1)
    with pytest.raises(ValueError, match="torch.uint32"):
        mb.chain(x.view(torch.int32), z, "solinas", 1)
    with pytest.raises(ValueError, match="power of two"):
        mb.fused_chain(torch.zeros((4096, 4), dtype=torch.uint32),
                       fields.GF32, 1)
    with pytest.raises(ValueError, match="power of two"):
        mb.fused_chain(torch.zeros((12, 4), dtype=torch.uint32),
                       fields.GF32, 1)
    with pytest.raises(ValueError, match="torch.uint32"):
        mb.copy(torch.zeros(4, dtype=torch.int64))
