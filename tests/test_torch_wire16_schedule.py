"""K10's schedule against the reference, on the CPU.

The GF16 wire pair's last pass (``fastecc_tpu_torch/csrc/row.cu``
``row_wire16_kernel``, on ``csrc/regstages.cuh``) cannot run here, so this
file models its exact schedule in numpy: one block per (column b, lane
tile), lo's and hi's [A, TL] tiles each in an exchange region of its own
and the inner table behind them in a flat shared-memory buffer, K3's GF16
forward transform on each half (the A1-point DIF in registers, the inner
twiddles, the exchange through the half's padded rows, the A2-point
DIFs), then the epilogue from the registers: the stored word (lo & 0xFFFF)
| hi << 16 (u32: 0x10000 stored as 0), and each lane's escape bits (bit
2t for lo, 2t + 1 for hi of lane 8g + t) OR-ed into the bitmap the entry
zeroes, as K12 does.

The model is held bit for bit against ``wire16_pass_b2`` of the JAX
package in interpret mode (two small shapes), against the JAX package's
``ntt_jit`` forward on each half, packed as ``_wire16_parts`` packs it,
at every A = 2 .. 1024 over Wu = 8 and 40, and on dense escapes (with
saturated 0xFFFF words: eight lanes' bits OR-ed into one word) at TL = 32
and 16. The kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fastecc_tpu import fields as jfields
from fastecc_tpu.kernels import ntt_mfa as jmfa
from fastecc_tpu.ntt import ntt_jit as jntt
from fastecc_tpu_torch import fields, ntt
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
from fastecc_tpu_torch.kernels import ntt_mfa as m

from test_torch_row_schedule import Arith, bitrev, dif_regs

GF16 = fields.GF16
SMEM_BYTES = 232448   # what one block may use on the H100
REGS_PER_SM = 65536
COLS = 2              # B of [A, B, Wu]


def geometry(a):
    """row.cu's compile-time shape of K10's block at A = a (RegSplit)."""
    la = a.bit_length() - 1
    a1, a2 = m._row_split(a)
    tl = min(16384 // a, 32)
    g = dict(a1=a1, a2=a2, la1=la - la // 2, la2=la // 2, tl=tl,
             threads=a2 * tl, row_words=(a1 + 1) * tl)
    g["exch"] = a2 * g["row_words"]
    g["tw_words"] = a2 * (a1 + 1)
    g["smem"] = 2 * g["exch"] + g["tw_words"]     # lo's, hi's, the table
    return g


def transform(smem, base, g, t, l, f):
    """regstages.cuh reg_transform, GF16 forward, on the tile at ``base``
    (its exchange region) with the inner table behind both regions;
    returns the registers: r[j A2 + bitrev(k2)] = X[t + A2 j + A1 k2]."""
    a1, a2, tl, rw = g["a1"], g["a2"], g["tl"], g["row_words"]
    tw = 2 * g["exch"]
    r = [smem[..., base + (n1 * a2 + t) * tl + l] for n1 in range(a1)]
    dif_regs(r, a1, 0, f, GF16, False)
    for k1 in range(a1):
        v = r[bitrev(k1, g["la1"])]
        if k1:
            v = f.mul(v, smem[..., tw + t * (a1 + 1) + k1])
        smem[..., base + t * rw + k1 * tl + l] = v
    r = [None] * a1
    for j in range(a1 // a2):
        for n2 in range(a2):
            r[j * a2 + n2] = smem[..., base + (t + a2 * j) * tl + l
                                  + n2 * rw]
        dif_regs(r, a2, j * a2, f, GF16, False)
    return r


def k10_model(lo, hi):
    """row.cu's K10 on lo, hi [A, B, L] -> (stored [A * B, L], bitmap
    [A * B, L / 8]): every block and thread."""
    a, nb, lanes = lo.shape
    g = geometry(a)
    f = Arith(GF16)
    a1, a2, tl = g["a1"], g["a2"], g["tl"]
    tw = m._row_inner_twiddles(GF16.name, a, False).reshape(-1)
    stored = np.full((a, nb, lanes), 0xDEAD, np.uint64)
    bitmap = np.zeros((a, nb, lanes // 8), np.uint64)   # the entry's memset
    t = np.arange(a2)[:, None]           # thread = (t, l), [A2, TL]
    l = np.arange(tl)[None, :]
    shape = np.broadcast_shapes(t.shape, l.shape)
    sh = (2 * (l & 7)).astype(np.uint64)  # the lane's place in its group
    for b in range(nb):
        for l0 in range(0, lanes, tl):
            smem = np.zeros(g["smem"], np.uint64)
            cols = np.arange(l0, l0 + tl)
            for base, x in ((0, lo), (g["exch"], hi)):
                tile = np.zeros((a, tl), np.uint64)
                tile[:, cols < lanes] = x[:, b, cols[cols < lanes]]
                smem[base:base + a * tl] = tile.reshape(-1)
            e = np.arange(a)
            smem[2 * g["exch"] + e // a1 * (a1 + 1) + e % a1] = tw
            rlo = transform(smem, 0, g, t, l, f)
            rhi = transform(smem, g["exch"], g, t, l, f)
            lv = np.broadcast_to(l0 + l < lanes, shape)   # the others return
            lane = np.broadcast_to(l0 + l, shape)[lv]
            for j in range(a1 // a2):
                for k2 in range(a2):
                    reg = j * a2 + bitrev(k2, g["la2"])
                    k = np.broadcast_to(t + a2 * j + a1 * k2, shape)[lv]
                    vl, vh = rlo[reg], rhi[reg]
                    word = ((vl & np.uint64(0xFFFF))
                            | (vh << np.uint64(16))) & np.uint64(0xFFFFFFFF)
                    stored[k, b, lane] = word[lv]
                    bits = ((vl >> np.uint64(16))
                            | (vh >> np.uint64(16)) << np.uint64(1)) << sh
                    np.bitwise_or.at(bitmap, (k, b, lane >> 3), bits[lv])
    return (stored.reshape(a * nb, lanes).astype(np.uint32),
            bitmap.reshape(a * nb, lanes // 8).astype(np.uint32))


def ref_k10(lo, hi):
    """The JAX package: ntt_jit forward (unscaled) on each half along
    axis 0 of [A, B, L], packed as _wire16_parts packs it."""
    a, nb, lanes = lo.shape
    outs = [np.asarray(jntt(jnp.asarray(h.reshape(a, nb * lanes)),
                            field=jfields.GF16, inverse=False,
                            scale=False)).astype(np.uint64).reshape(
                                a * nb, lanes) for h in (lo, hi)]
    lo_t, hi_t = outs
    stored = (lo_t & 0xFFFF) | ((hi_t & 0xFFFF) << np.uint64(16))
    esc = (lo_t >> np.uint64(16)) | ((hi_t >> np.uint64(16)) << np.uint64(1))
    shifts = (2 * np.arange(8)).astype(np.uint64)
    bitmap = (esc.reshape(a * nb, lanes // 8, 8) << shifts).sum(axis=-1)
    return stored.astype(np.uint32), bitmap.astype(np.uint32)


def rand_halves(a, wu, seed):
    """lo, hi [A, 2, Wu] GF16 values with 0x10000 at about a tenth."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.integers(0, GF16.p, size=(a, COLS, wu), dtype=np.uint64)
        x[rng.random(x.shape) < 0.1] = 0x10000
        out.append(x.astype(np.uint32))
    return out


def assert_parts_equal(got, want):
    for a_, b_ in zip(got, want):
        np.testing.assert_array_equal(a_, b_)


@pytest.mark.parametrize("la", range(1, 11))
def test_k10_geometry_fits_the_card(la):
    """K10's block at A = 2^la fits an SM's shared memory and threads; hi's
    region starts on a 16-byte boundary (its 16-byte copies); both halves'
    registers fit; a lane tile holds whole 8-lane groups (a lane's place
    in its bitmap word is l mod 8)."""
    g = geometry(1 << la)
    assert 4 * g["smem"] <= SMEM_BYTES
    assert g["threads"] <= 1024 and g["threads"] % 32 == 0
    assert (1 << la) * g["tl"] <= g["exch"] and g["exch"] % 4 == 0
    assert 2 * g["a1"] * g["threads"] <= REGS_PER_SM
    assert g["tl"] % 8 == 0


@pytest.mark.parametrize("wu", [8, 40])
@pytest.mark.parametrize("la", range(1, 11))
def test_k10_schedule_matches_reference(la, wu):
    """The model == the JAX package's forward transform on each half,
    packed, at A = 2^la over [A, 2, Wu] (Wu = 40: ragged against every
    lane tile), 0x10000 in about a tenth of the inputs."""
    lo, hi = rand_halves(1 << la, wu, 0x10 + 4 * la + wu)
    assert_parts_equal(k10_model(lo, hi), ref_k10(lo, hi))


@pytest.mark.parametrize("shape", [(16, 8, 256), (64, 8, 128)])
def test_k10_schedule_matches_pallas_interpret(shape):
    """The model == wire16_pass_b2 of the JAX package in interpret mode
    (its tile of 8 columns and 128 lanes divides the shape), and == the
    port's wrapper on the CPU (its plain version)."""
    a, nb, wu = shape
    rng = np.random.default_rng(a + wu)
    lo, hi = (rng.integers(0, GF16.p, size=shape, dtype=np.uint64).astype(
        np.uint32) for _ in range(2))
    got = k10_model(lo, hi)
    want = jmfa.wire16_pass_b2(jnp.asarray(lo), jnp.asarray(hi),
                               jfields.GF16, interpret=True, tile=(8, 128))
    assert_parts_equal(got, [np.asarray(w) for w in want])
    plain = m.wire16_pass_b2(from_numpy_u32(lo, "cpu"),
                             from_numpy_u32(hi, "cpu"), GF16)
    assert_parts_equal(got, [to_numpy_u32(p) for p in plain])


@pytest.mark.parametrize("a,nb,wu", [(64, 2, 64), (1024, 1, 48)])
def test_k10_schedule_dense_escapes(a, nb, wu):
    """Outputs mostly 0x10000 (the inverse transform of such outputs is
    the input): many bits a word from eight lanes' ORs, saturated 0xFFFF
    words, at TL = 32 and 16; the model == the expected words and the
    plain version."""
    rng = np.random.default_rng(0xDE + a)
    want, pre = [], []
    for _ in range(2):
        w = np.where(rng.random((a, nb, wu)) < 0.9, np.uint32(0x10000),
                     rng.integers(0, 0x10000, (a, nb, wu)).astype(np.uint32))
        want.append(w.reshape(a * nb, wu))
        pre.append(ntt.ntt_host(w.reshape(a, nb * wu), GF16,
                                inverse=True).reshape(a, nb, wu))
    st = (want[0] & 0xFFFF) | ((want[1] & 0xFFFF) << np.uint32(16))
    sh = (2 * np.arange(8)).astype(np.uint32)
    bm = (((want[0] >> 16).reshape(-1, wu // 8, 8) << sh)
          | ((want[1] >> 16).reshape(-1, wu // 8, 8) << (sh + 1))).sum(
              axis=-1).astype(np.uint32)
    assert (bm == 0xFFFF).any()
    got = k10_model(*pre)
    assert_parts_equal(got, (st, bm))
    plain = m.wire16_pass_b2(from_numpy_u32(pre[0], "cpu"),
                             from_numpy_u32(pre[1], "cpu"), GF16)
    assert_parts_equal(got, [to_numpy_u32(p) for p in plain])
