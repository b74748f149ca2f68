"""K15's schedule against the reference, on the CPU.

K15 (``fastecc_tpu_torch/csrc/microbench.cu`` fused_chain_kernel) runs
``depth`` forward c-point transforms on the register-stage engine of
``csrc/regstages.cuh``, c = 2 .. 2048. It cannot run here, so this file
models its exact schedule in numpy, every block (lane tile) at once: the
[c, TL] tile and the [A2, A1] inner table in a flat shared-memory buffer,
the tile read into the registers in the order a transform leaves them,
then per transform the renaming into step 1's order (the register
hand-off of col.cu's seam), the A1-point in-register DIF with its
compile-time constants, the inner twiddles, the exchange through padded
rows, the A2-point DIFs, and at the end the natural-order store from the
registers, with the kernel's index maps and butterfly order. The model is
held bit for bit against the JAX package's ``_fused_chain_kernel``
(``fastecc_tpu/kernels/microbench.py``) in interpret mode at every c in
both fields and depths 0-3, and against the JAX transform chained on
ragged lanes. The kernel itself is held against its plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fastecc_tpu import fields as jfields
from fastecc_tpu.kernels import microbench as ref
from fastecc_tpu.kernels import ntt_mfa as ref_mfa
from fastecc_tpu.ntt import ntt_jit as jntt
from fastecc_tpu_torch import fields
from fastecc_tpu_torch.kernels import ntt_mfa as m

from test_torch_row_schedule import Arith, bitrev, dif_regs

FIELDS = [fields.GF32, fields.GF16]
MAX_LOG = 11        # microbench.cu kFusedMaxLog: c = 2048
SMEM_BYTES = 232448  # what one block may use on the H100


def geometry(a):
    """microbench.cu's compile-time shape of an a-point block
    (regstages.cuh RegSplit)."""
    la = a.bit_length() - 1
    a1, a2 = m._row_split(a)
    tl = min(16384 // a, 32)
    return dict(la1=la - la // 2, la2=la // 2, a1=a1, a2=a2, tl=tl,
                rho=a1 // a2, row_words=(a1 + 1) * tl,
                exch=a2 * (a1 + 1) * tl, tw_words=a2 * (a1 + 1))


def fused_model(x, field, depth):
    """fused_chain_kernel on x [c, L]: blocks b of lanes [b TL, (b+1) TL),
    threads (t = n2, lane l), all blocks at once."""
    a, lanes = x.shape
    g = geometry(a)
    a1, a2, tl, rho = g["a1"], g["a2"], g["tl"], g["rho"]
    f = Arith(field)
    nb = -(-lanes // tl)
    smem = np.zeros((nb, g["exch"] + g["tw_words"]), np.uint64)
    # the copies: block b's tile[a * TL + l] = x[a, b TL + l], zero past L
    xp = np.zeros((a, nb * tl), np.uint64)
    xp[:, :lanes] = x
    smem[:, :a * tl] = xp.reshape(a, nb, tl).transpose(1, 0, 2).reshape(
        nb, a * tl)
    e = np.arange(a)
    smem[:, g["exch"] + e // a1 * (a1 + 1) + e % a1] = \
        m._row_inner_twiddles(field.name, a, False).reshape(-1)
    blk = np.arange(nb)[:, None, None]
    t = np.arange(a2)[None, :, None]
    l = np.arange(tl)[None, None, :]

    def handoff(n1):    # register of step 1's element n1 A2 + t
        return n1 % rho * a2 + bitrev(n1 // rho, g["la2"])

    r = [None] * a1
    for n1 in range(a1):
        r[handoff(n1)] = smem[blk, (n1 * a2 + t) * tl + l]
    for _ in range(depth):
        y = [r[handoff(n1)] for n1 in range(a1)]
        dif_regs(y, a1, 0, f, field, False)
        # the inner twiddles into exchange row t
        for k1 in range(a1):
            v = y[bitrev(k1, g["la1"])]
            if k1:
                v = f.mul(v, smem[blk, g["exch"] + t * (a1 + 1) + k1])
            smem[blk, t * g["row_words"] + k1 * tl + l] = v
        # step 2: columns k1 = t + A2 j
        for j in range(rho):
            for n2 in range(a2):
                y[j * a2 + n2] = smem[blk, (t + a2 * j) * tl + l
                                      + n2 * g["row_words"]]
            dif_regs(y, a2, j * a2, f, field, False)
        r = y
    # the store: out[t + A2 j + A1 k2, b TL + l] = r[j A2 + bitrev(k2)]
    out = np.zeros((a, nb * tl), np.uint64)
    for j in range(rho):
        for k2 in range(a2):
            out[t + a2 * j + a1 * k2, blk * tl + l] = \
                r[j * a2 + bitrev(k2, g["la2"])]
    return out[:, :lanes].astype(np.uint32)


def rand_input(field, shape, seed):
    """Residues below p; GF16 with 0x10000 (= -1) at about 10% of them."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)
    if not field.use_mont:
        x[rng.random(shape) < 0.1] = 0x10000
    return x


@functools.lru_cache(maxsize=None)
def ref_fused(field_name, c, depth):
    """The reference's _fused_chain_kernel in interpret mode on one row
    tile [c, 8, 128] (input seeded by c and the field)."""
    jf = jfields.FIELDS[field_name]
    tw = jnp.asarray(ref_mfa._packed_stage_twiddles(field_name, c,
                                                    False))[:, None]
    w3 = jnp.asarray(ref_mfa._packed_w3_twiddles(field_name, c,
                                                 False))[:, None]
    x = rand_input(fields.FIELDS[field_name], (c, ref_mfa._TR, ref._TL),
                   0xF05ED + c + jf.use_mont)
    vec = pl.BlockSpec((c, 1), lambda i: (0, 0), memory_space=pltpu.VMEM)
    blk = pl.BlockSpec((c, ref_mfa._TR, ref._TL), lambda i: (0, i, 0),
                       memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(ref._fused_chain_kernel, field=jf, c=c,
                          depth=depth),
        grid=(1,), in_specs=[vec, vec, blk], out_specs=blk,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.uint32),
        interpret=True)(tw, w3, jnp.asarray(x))
    return x, np.asarray(out)


def test_geometry_fits_the_card():
    """At every c = 2 .. 2048: A1 * A2 = c with A1 in {A2, 2 A2} (64 x 32
    at 2048, the passes' splits below), a block of A2 * TL <= 1024 threads
    whose exchange holds the [c, TL] tile and whose shared memory (the
    exchange and the inner table) fits one block's 227 KB."""
    for la in range(1, MAX_LOG + 1):
        a = 1 << la
        g = geometry(a)
        assert g["a1"] * g["a2"] == a and g["rho"] in (1, 2)
        assert g["a2"] * g["tl"] <= 1024 and g["exch"] >= a * g["tl"]
        assert 4 * (g["exch"] + g["tw_words"]) <= SMEM_BYTES
    g = geometry(2048)
    assert (g["a1"], g["a2"], g["tl"], g["a2"] * g["tl"]) == (64, 32, 8, 256)


@pytest.mark.parametrize("depth", range(4))
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("la", range(1, MAX_LOG + 1))
def test_fused_schedule_matches_reference(la, field, depth):
    """The kernel's schedule == the reference's _fused_chain_kernel in
    interpret mode, bit for bit: c = 2^la, depth transforms, one row tile
    (1024 lanes: 128 blocks at c = 2048)."""
    c = 1 << la
    x, want = ref_fused(field.name, c, depth)
    got = fused_model(x.reshape(c, -1), field, depth)
    np.testing.assert_array_equal(got, want.reshape(c, -1))


@pytest.mark.parametrize("lanes", [13, 40])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("la", range(1, MAX_LOG + 1))
def test_fused_schedule_ragged_lanes(la, field, lanes):
    """On ragged lanes (zero-filled past L in the last block, never
    stored), three transforms of the model == the JAX package's forward
    transform applied three times."""
    c = 1 << la
    x = rand_input(field, (c, lanes), 0xF0 + 2 * la + field.use_mont)
    want = jnp.asarray(x)
    for _ in range(3):
        want = jntt(want, field=jfields.FIELDS[field.name], inverse=False,
                    scale=False)
    np.testing.assert_array_equal(fused_model(x, field, 3),
                                  np.asarray(want))
