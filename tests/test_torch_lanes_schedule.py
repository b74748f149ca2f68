"""K11's and K12's schedule against the reference, on the CPU.

The one-pass lanes pair (``fastecc_tpu_torch/csrc/lanes.cu``
``pair_lanes_kernel`` (K11, GF32 and GF16) and ``pair_lanes_wire16_kernel``
(K12, the GF16 wire pair), one schedule on ``csrc/regstages.cuh``)
cannot run here, so this file models its exact schedule in numpy: one
block per lane tile (K12: per lane tile and half), the [k, TL] tile of
u32 words in a flat shared-memory buffer, each word taken as it is (K11)
or split into its half (K12: lo = v & 0xFFFF, hi = v >> 16) as step 1
reads it, the inverse transform, the mid multiply g^m k^-1 as its output
is renamed into the forward transform's step 1, the forward transform,
and the epilogue: K11 stores each output word, K12 stores its u16 half
of every stored word and ORs its escape bits into a zeroed bitmap. Below
2^12 the transforms take the engine's one-exchange split (RegSplit);
from 2^12 on the two-exchange split k = B1 * A1 * A2 (an outer B1-point
level in registers, the level twiddles, an exchange into padded rows,
the inner M-point transforms on the engine with B1 * TL lanes, and the
mirror of it for the forward), with the same index maps, butterfly order
and tables as the kernel.

The K12 model is held bit for bit against ``ntt_pair_lanes_wire16_pallas``
in interpret mode (two small k, escapes present), against the JAX
package's ``ntt_jit`` inverse -> ``mul_prepared`` by the mid table ->
forward, packed as ``_wire16_parts`` packs it, at every k = 4 .. 2^13
over Wu = 8 and 40, and on one dense-escape case; the K11 model against
the same JAX transforms at every k = 4 .. 2^13 in both fields on ragged
lanes, and against ``ntt_pair_lanes_pallas`` in interpret mode at two
small k in GF32. The kernels themselves are held against the plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from fastecc_tpu import fields as jfields
from fastecc_tpu.kernels import ntt_mfa as jmfa
from fastecc_tpu.ntt import mul_prepared as jmul
from fastecc_tpu.ntt import ntt_jit as jntt
from fastecc_tpu_torch import fields
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
from fastecc_tpu_torch.kernels import ntt_mfa as m

from test_torch_row_schedule import Arith, bitrev, dif_regs

GF16 = fields.GF16
FIELDS = [fields.GF32, fields.GF16]
LANES_CU = (Path(__file__).resolve().parents[1] / "fastecc_tpu_torch"
            / "csrc" / "lanes.cu").read_text()
SMEM_BYTES = 232448  # what one block may use on the H100
REGS_PER_SM = 65536


def lanes_cu_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", LANES_CU)[1])


TWO_EXCHANGE_LOG = lanes_cu_constant("kTwoExchangeLog")
TWO_EXCHANGE_LOG_K11 = lanes_cu_constant("kTwoExchangeLogK11")
TL3 = lanes_cu_constant("kTwoExchangeTL")
NARROW_TL = lanes_cu_constant("kNarrowTL")


def geometry(k, field=GF16, wire=True):
    """lanes.cu's compile-time shape of a k-point block of K12 (``wire``)
    or of K11 in ``field`` (LanesShape): the register split (A1, A2) of
    the (inner) transform, its lane count TL' and the block's lanes TL,
    threads, elements a thread holds, shared words, the minimum of blocks
    an SM its launch bound asks for."""
    la = k.bit_length() - 1
    tl3 = NARROW_TL if not wire and field.use_mont and la == 13 else TL3
    if la < (TWO_EXCHANGE_LOG if wire else TWO_EXCHANGE_LOG_K11):
        a1, a2 = m._row_split(k)
        tl = min(16384 // k, 32)
        g = dict(b1=0, a1=a1, a2=a2, tl=tl, tlp=tl, m=k)
    else:
        b1 = 1 << -(-la // 3)
        mm = k // b1
        g = dict(b1=b1, a1=b1, a2=mm // b1, tl=tl3, tlp=b1 * tl3, m=mm)
    g["la1"] = g["a1"].bit_length() - 1
    g["la2"] = g["a2"].bit_length() - 1
    g["threads"] = g["a2"] * g["tlp"]
    g["row_words"] = (g["a1"] + 1) * g["tlp"]
    g["exch"] = g["a2"] * g["row_words"]
    g["tw_words"] = g["a2"] * (g["a1"] + 1)
    g["smem"] = g["exch"] + 2 * g["tw_words"]
    g["min_blocks"] = 1 if g["b1"] else 2
    return g


def transform_regs(smem, r, g, tw_off, inv, t, l, f, field):
    """regstages.cuh reg_transform_regs for the (inner) split of ``g``:
    A1-point DIF, inner twiddles, the exchange through padded rows, the
    A2-point DIFs; returns the new registers."""
    a1, a2, tlp, rw = g["a1"], g["a2"], g["tlp"], g["row_words"]
    dif_regs(r, a1, 0, f, field, inv)
    for k1 in range(a1):
        v = r[bitrev(k1, g["la1"])]
        if k1:
            v = f.mul(v, smem[:, tw_off + t * (a1 + 1) + k1])
        smem[:, t * rw + k1 * tlp + l] = v
    r = [None] * a1
    for j in range(a1 // a2):
        for n2 in range(a2):
            r[j * a2 + n2] = smem[:, (t + a2 * j) * tlp + l + n2 * rw]
        dif_regs(r, a2, j * a2, f, field, inv)
    return r


def handoff(r, g, mid_of, f):
    """The renaming of the first transform's output into the second's
    step 1, x the mid factor of each element's index (col.cu's seam)."""
    rho = g["a1"] // g["a2"]
    return [f.mul(r[n1 % rho * g["a2"] + bitrev(n1 // rho, g["la2"])],
                  mid_of(n1)) for n1 in range(g["a1"])]


def pair_model(words, field, g_seed, read, wire):
    """lanes.cu's pair_columns<F, LA, WIRE> on every lane tile of words
    [k, L] at once, each tile word taken as read(word) at step 1. Returns
    (outs, lane): outs the threads' results in emit order as (v, row), v
    [tiles, *threads] values and row their natural-order row; lane each
    thread's lane."""
    k, wu = words.shape
    g = geometry(k, field, wire)
    f = Arith(field)
    tl, a1, a2, b1 = g["tl"], g["a1"], g["a2"], g["b1"]
    tiles = -(-wu // tl)
    mid = m._pair_mid_table(field.name, k, g_seed).reshape(-1).astype(
        np.uint64)
    inner_k, inner_a1 = (g["m"], b1) if b1 else (k, a1)
    tw = [m._split_twiddles(field.name, inner_k, inner_a1, inv).reshape(-1)
          for inv in (True, False)]
    tw_off = [g["exch"], g["exch"] + g["tw_words"]]
    lane0 = np.arange(tiles)[:, None, None] * tl        # block's l0
    smem = np.zeros((tiles, g["smem"]), np.uint64)
    # the copies: tile[a * TL + l] of raw words, lanes past Wu zero
    cols = (lane0 + np.arange(tl)[None, None, :])[:, 0, :]   # [T, TL]
    tile = np.zeros((tiles, k, tl), np.uint64)
    live = cols < wu
    tile.transpose(0, 2, 1)[live] = words.T[cols[live]]
    smem[:, :k * tl] = tile.reshape(tiles, -1)
    e = np.arange(g["tw_words"] // (a1 + 1) * a1)
    for off, table in zip(tw_off, tw):
        smem[:, off + e // a1 * (a1 + 1) + e % a1] = table
    if not b1:
        t = np.arange(a2)[:, None]
        l = np.arange(tl)[None, :]
        r = [read(smem[:, (n1 * a2 + t) * tl + l]) for n1 in range(a1)]
        r = transform_regs(smem, r, g, tw_off[0], True, t, l, f, field)
        r = handoff(r, g, lambda n1: mid[t + a2 * n1], f)
        r = transform_regs(smem, r, g, tw_off[1], False, t, l, f, field)
        outs = [(r[j * a2 + bitrev(k2, g["la2"])], t + a2 * j + a1 * k2)
                for j in range(a1 // a2) for k2 in range(a2)]
        return outs, lane0 + l
    mm, lb = g["m"], b1.bit_length() - 1
    orow = (b1 + 1) * tl
    lvl_i = m._lanes_level_twiddles(field.name, k, True).reshape(-1)
    lvl_f = m._lanes_level_twiddles(field.name, k, False).reshape(-1)
    # outer inverse level: thread (t, l) holds column t (stride M)
    t = np.arange(mm)[:, None]
    l = np.arange(tl)[None, :]
    r = [read(smem[:, (n1 * mm + t) * tl + l]) for n1 in range(b1)]
    dif_regs(r, b1, 0, f, field, True)
    for k1 in range(b1):
        v = r[bitrev(k1, lb)]
        if k1:
            v = f.mul(v, lvl_i[k1 * mm + t])
        smem[:, t * orow + k1 * tl + l] = v
    # the inner transforms: thread (t3, lane' = k1 * TL + l)
    t3 = np.arange(a2)[:, None]
    lp = np.arange(g["tlp"])[None, :]
    y = [smem[:, (n1 * a2 + t3) * orow + lp] for n1 in range(a1)]
    y = transform_regs(smem, y, g, tw_off[0], True, t3, lp, f, field)
    k1 = lp // tl
    y = handoff(y, g, lambda n1: mid[k1 + b1 * (t3 + a2 * n1)], f)
    y = transform_regs(smem, y, g, tw_off[1], False, t3, lp, f, field)
    # forward outer level: x w_k^(kk r), exchange, B1-point DIFs
    for j in range(a1 // a2):
        for k2 in range(a2):
            kk = t3 + a2 * j + a1 * k2
            smem[:, kk * orow + lp] = f.mul(
                y[j * a2 + bitrev(k2, g["la2"])], lvl_f[kk * b1 + k1])
    r = [smem[:, t * orow + rr * tl + l] for rr in range(b1)]
    dif_regs(r, b1, 0, f, field, False)
    return [(r[bitrev(kb, lb)], t + mm * kb) for kb in range(b1)], lane0 + l


def k11_model(x, field, g_seed):
    """lanes.cu's K11 on [k, L] field values: every block (lane tile) and
    thread at once, each output one u32 store."""
    k, lanes = x.shape
    outs, lane = pair_model(x, field, g_seed, lambda v: v, False)
    out = np.full((k, lanes), 0xDEAD, np.uint64)
    for v, row in outs:
        ok = np.broadcast_to(lane < lanes, v.shape)
        rows = np.broadcast_to(row, v.shape)[ok]
        out[rows, np.broadcast_to(lane, v.shape)[ok]] = v[ok]
    return out.astype(np.uint32)


def k12_model(pairs, g_seed):
    """lanes.cu's K12 on u32 pairs [k, Wu] -> (stored [k, Wu], bitmap
    [k, Wu / 8]): every block (half, lane tile) and thread at once."""
    k, wu = pairs.shape
    halves16 = np.zeros((k, wu, 2), np.uint64)
    bitmap = np.zeros((k, wu // 8), np.uint64)
    for half in (0, 1):
        def split(v):
            return (v >> np.uint64(16)) if half else (v & np.uint64(0xFFFF))

        outs, lane = pair_model(pairs, GF16, g_seed, split, True)
        # the epilogue: the half's u16 of each stored word, the escape
        # bits OR-ed into the zeroed bitmap (atomicOr)
        for v, row in outs:
            ok = np.broadcast_to(lane < wu, v.shape)
            rows = np.broadcast_to(row, v.shape)[ok]
            lanes_ = np.broadcast_to(lane, v.shape)[ok]
            vv = v[ok]
            halves16[rows, lanes_, half] = vv & np.uint64(0xFFFF)
            esc = vv >> np.uint64(16)
            np.bitwise_or.at(bitmap, (rows, lanes_ >> 3),
                             esc << (2 * (lanes_ & 7) + half).astype(
                                 np.uint64))
    stored = halves16[..., 0] | (halves16[..., 1] << np.uint64(16))
    return stored.astype(np.uint32), bitmap.astype(np.uint32)


def ref_pair16(pairs, g_seed):
    """The JAX package: ntt_jit inverse (unscaled) -> x the mid table ->
    forward on each half, packed as _wire16_parts packs it."""
    jf = jfields.GF16
    k, wu = pairs.shape
    mid = jnp.asarray(jmfa._pair_mid_table(jf.name, k, g_seed))
    outs = []
    for h in (pairs & 0xFFFF, pairs >> 16):
        y = jntt(jnp.asarray(h), field=jf, inverse=True, scale=False)
        y = jntt(jmul(jf, y, mid), field=jf, inverse=False, scale=False)
        outs.append(np.asarray(y).astype(np.uint64))
    lo, hi = outs
    stored = (lo & 0xFFFF) | ((hi & 0xFFFF) << np.uint64(16))
    esc = ((lo >> np.uint64(16)) | ((hi >> np.uint64(16)) << np.uint64(1)))
    shifts = (2 * np.arange(8)).astype(np.uint64)
    bitmap = (esc.reshape(k, wu // 8, 8) << shifts).sum(axis=-1)
    return stored.astype(np.uint32), bitmap.astype(np.uint32)


def rand_pairs(k, wu, seed):
    return np.random.default_rng(seed).integers(
        0, 1 << 32, size=(k, wu), dtype=np.uint64).astype(np.uint32)


def assert_parts_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("la", range(2, 14))
def test_geometry_fits_the_card(la):
    """Each k's block fits an SM's shared memory and threads, the
    two-exchange split keeps every thread at 32 elements or fewer, and
    the threads of each level agree (B1 * M columns = A2 * TL' lanes')."""
    k = 1 << la
    g = geometry(k)
    assert 4 * g["smem"] <= SMEM_BYTES
    assert g["threads"] <= 1024
    assert k * g["tl"] <= g["exch"]                  # the tile fits
    assert g["a1"] * g["threads"] <= REGS_PER_SM // 2   # data registers
    if g["b1"]:
        assert g["a1"] <= 32 and g["a1"] >= g["a2"]
        assert g["b1"] * g["m"] == k and g["a1"] * g["a2"] == g["m"]
        assert g["m"] * g["tl"] == g["threads"]      # outer = inner threads
        assert g["tlp"] >= 32                        # conflict-free rows
        assert g["exch"] == g["m"] * (g["b1"] + 1) * g["tl"]
    assert (g["b1"] != 0) == (k >= m.K12_TWO_EXCHANGE_K)
    assert g["b1"] in (0, m._lanes_b1(k))


def test_python_split_matches_the_kernel():
    assert m.K12_TWO_EXCHANGE_K == 1 << TWO_EXCHANGE_LOG
    assert m.K11_TWO_EXCHANGE_K == 1 << TWO_EXCHANGE_LOG_K11


@pytest.mark.parametrize("wu", [8, 40])
@pytest.mark.parametrize("la", range(2, 14))
def test_k12_schedule_matches_reference(la, wu):
    """The model == the JAX package's inverse, mid multiply and forward on
    each half, packed, at k = 2^la over Wu lanes (ragged against every
    lane tile of 16 or more)."""
    k = 1 << la
    g_seed = GF16.root_of_order(2 * k)
    pairs = rand_pairs(k, wu, 0x12 + 16 * la + wu)
    assert_parts_equal(k12_model(pairs, g_seed), ref_pair16(pairs, g_seed))


@pytest.mark.parametrize("k", [1 << 8, 1 << 9])
def test_k12_schedule_matches_pallas_interpret(k):
    """The model == ntt_pair_lanes_wire16_pallas in interpret mode over
    1024 lanes of random wire words (4 KB blocks), escape bits present."""
    raw = np.random.default_rng(0).integers(0, 256, (k, 4096),
                                            dtype=np.uint8)
    pairs = np.ascontiguousarray(raw).view(np.uint32)
    g_seed = GF16.root_of_order(2 * k)
    st, bm = k12_model(pairs, g_seed)
    st_ref, bm_ref = jmfa.ntt_pair_lanes_wire16_pallas(
        jnp.asarray(pairs), jfields.GF16, g_seed, interpret=True)
    assert_parts_equal((st, bm), (np.asarray(st_ref), np.asarray(bm_ref)))
    assert bm.any(), "case no longer hits escapes"


def dense_escape_pairs(k, wu, g_seed, seed):
    """[k, wu] pairs whose pair output is ~90% 0x10000 in each half: the
    plain pair with the inverse seed applied to such outputs (preimage
    values of 0x10000, which a u16 cannot hold, become 0)."""
    rng = np.random.default_rng(seed)
    halves = []
    for _ in range(2):
        want = np.where(rng.random((k, wu)) < 0.9, np.uint32(0x10000),
                        rng.integers(0, 0x10000, (k, wu)).astype(np.uint32))
        pre = to_numpy_u32(m.pair_lanes_plain(
            from_numpy_u32(want, "cpu"), GF16, GF16.inv_host(g_seed)))
        halves.append(np.where(pre == 0x10000, 0, pre).astype(np.uint64))
    return (halves[0] | (halves[1] << np.uint64(16))).astype(np.uint32)


@pytest.mark.parametrize("k", [1 << 5, 1 << 13])
def test_k12_schedule_dense_escapes(k):
    """Outputs mostly 0x10000: bitmap words with many bits from both
    halves and from several blocks (TL = 2 at 2^13: four blocks a word),
    saturated words among them; the model == the reference and the plain
    version."""
    wu = 40
    g_seed = GF16.root_of_order(2 * k)
    pairs = dense_escape_pairs(k, wu, g_seed, 0xDE5 + k)
    got = k12_model(pairs, g_seed)
    assert_parts_equal(got, ref_pair16(pairs, g_seed))
    plain = m.pair_lanes_wire16_plain(from_numpy_u32(pairs, "cpu"), GF16,
                                      g_seed)
    assert_parts_equal(got, tuple(to_numpy_u32(t) for t in plain))
    assert (got[1] == 0xFFFF).any()


def test_lanes16_tables():
    """The level twiddles are the [M, B1] powers w_k^(kk r), the inverse
    transposed; the wrapper's table tuple on the CPU matches the split."""
    k = 1 << 13
    b1 = m._lanes_b1(k)
    mm = k // b1
    w = GF16.root_of_order(k)
    fwd = m._lanes_level_twiddles(GF16.name, k, False)
    inv = m._lanes_level_twiddles(GF16.name, k, True)
    assert fwd.shape == (mm, b1) and inv.shape == (b1, mm)
    for kk, r in ((0, 5), (3, 7), (mm - 1, b1 - 1)):
        assert fwd[kk, r] == pow(w, kk * r, GF16.p)
        assert inv[r, kk] == pow(GF16.inv_host(w), kk * r, GF16.p)
    g_seed = GF16.root_of_order(2 * k)
    lvl_i, lvl_f, tw_i, tw_f, mid = m._lanes_tables_on(
        GF16.name, k, g_seed, m.K12_TWO_EXCHANGE_K, "cpu")
    assert lvl_i.numel() == lvl_f.numel() == k
    assert tw_i.numel() == (mm // b1) * b1 and mid.numel() == k
    small = m._lanes_tables_on(GF16.name, 1 << 11, g_seed,
                               m.K12_TWO_EXCHANGE_K, "cpu")
    assert small[0] is None and small[1] is None
    np.testing.assert_array_equal(
        to_numpy_u32(small[2]),
        m._row_inner_twiddles(GF16.name, 1 << 11, True).reshape(-1))


def ref_pair(x, field, g_seed):
    """The JAX package: ntt_jit inverse (unscaled) -> x the mid table ->
    forward, along axis 0 of [k, L]."""
    jf = jfields.FIELDS[field.name]
    mid = jnp.asarray(jmfa._pair_mid_table(jf.name, x.shape[0], g_seed))
    y = jntt(jnp.asarray(x), field=jf, inverse=True, scale=False)
    return np.asarray(jntt(jmul(jf, y, mid), field=jf, inverse=False,
                           scale=False))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("la", range(2, 14))
def test_k11_schedule_matches_reference(la, field):
    """K11's model == the JAX package's inverse, mid multiply and forward
    at k = 2^la over 13 lanes (ragged against every lane tile; GF16 inputs
    0x10000 at about a tenth)."""
    k = 1 << la
    g_seed = field.root_of_order(2 * k)
    rng = np.random.default_rng(0x11 + 4 * la + field.use_mont)
    x = rng.integers(0, field.p, size=(k, 13), dtype=np.uint64).astype(
        np.uint32)
    if not field.use_mont:
        x[rng.random(x.shape) < 0.1] = 0x10000
    np.testing.assert_array_equal(k11_model(x, field, g_seed),
                                  ref_pair(x, field, g_seed))


@pytest.mark.parametrize("k", [1 << 6, 1 << 8])
def test_k11_schedule_matches_pallas_interpret(k):
    """K11's model == ntt_pair_lanes_pallas in interpret mode over 128
    GF32 lanes, and == the port's K11 wrapper on the CPU (its plain
    version)."""
    f = fields.GF32
    x = np.random.default_rng(k).integers(
        0, f.p, size=(k, 128), dtype=np.uint64).astype(np.uint32)
    g_seed = f.root_of_order(2 * k)
    got = k11_model(x, f, g_seed)
    want = jmfa.ntt_pair_lanes_pallas(jnp.asarray(x), jfields.GF32, g_seed,
                                      interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, to_numpy_u32(m.ntt_pair_lanes(
        from_numpy_u32(x, "cpu"), f, g_seed)))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("la", range(2, 14))
def test_k11_geometry_fits_the_card(la, field):
    """Each of K11's instantiations (pair_lanes_kernel<F, LA>) fits the
    card: its shared memory and threads a block, and as many blocks an SM
    as its launch bound asks for; its data registers (two columns of A1
    elements) within the registers a thread may then take; the
    two-exchange split from 2^11 on keeps every thread at 32 elements or
    fewer."""
    k = 1 << la
    g = geometry(k, field, wire=False)
    assert 4 * g["smem"] <= SMEM_BYTES
    assert g["threads"] <= 1024
    assert k * g["tl"] <= g["exch"]
    assert g["min_blocks"] * 4 * g["smem"] <= 233472   # an SM's 228 KB
    assert g["min_blocks"] * g["threads"] <= 2048
    regs = min(255, REGS_PER_SM // (g["min_blocks"] * g["threads"]))
    assert 2 * g["a1"] <= regs
    assert (g["b1"] != 0) == (la >= TWO_EXCHANGE_LOG_K11)
    assert g["a1"] <= 32
    assert (g["b1"] != 0) == (k >= m.K11_TWO_EXCHANGE_K)
    assert g["b1"] in (0, m._lanes_b1(k))
    if g["tl"] < 4:
        assert field.use_mont and la == 13      # 4-byte copies
