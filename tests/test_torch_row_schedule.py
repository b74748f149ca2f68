"""K3's, K7's and K7-sel's schedule against the reference, on the CPU.

The pass-B kernels (``fastecc_tpu_torch/csrc/row.cu`` on
``csrc/regstages.cuh``) cannot run here, so this file models their exact
schedule in numpy: the [A, TL] tile in a flat shared-memory buffer, the
A1-point in-register DIF with its compile-time constants, the inner
twiddles from ``_row_inner_twiddles`` staged into padded rows, the
exchange through the padded rows, the A2-point DIFs and the bit-reversed
register reads of the store, with the same index maps and butterfly
order; for K7 also the block's table row staged behind the inner table
and the table multiply at every row of the store, for K7-sel the table
and mask rows and the select in the store (x the table at rows whose
mask is not 0, the original elsewhere). The model is held bit for bit
against the JAX package's transform (and, for K7 and K7-sel, its table
multiply and row select) at every A = 2 .. 1024 in both fields and both
directions, on ragged lanes. The kernels themselves are held against the
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fastecc_tpu import fields as jfields
from fastecc_tpu.ntt import mul_prepared as jmul
from fastecc_tpu.ntt import ntt_jit as jntt
from fastecc_tpu_torch import fields
from fastecc_tpu_torch.kernels import ntt_mfa as m
from fastecc_tpu_torch.ntt import _stage_twiddles

FIELDS = [fields.GF32, fields.GF16]
LANES = 13          # ragged: not a multiple of 4 nor of any lane tile
COLS = 3            # B of K7-sel's [A, B, L]: the table index k * B + b


def root_pow(field, inverse, order, j):
    """regstages.cuh's compile-time constant: prepared w_order^j."""
    p = field.p
    w = pow(field.g, (p - 1) // order, p)
    if inverse:
        w = pow(w, p - 2, p)
    c = pow(w, j, p)
    return (c << 32) % p if field.use_mont else c


def bitrev(v, bits):
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


class Arith:
    """The kernel's field operations on numpy uint64 arrays (canonical
    residues; GF32 multiplies are the REDC of a * prepared)."""

    def __init__(self, field):
        self.p = np.uint64(field.p)
        self.mont = field.use_mont
        self.rinv = np.uint64(pow(1 << 32, field.p - 2, field.p))

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a + self.p - b) % self.p

    def mul(self, a, b_prepared):
        prod = (a * np.uint64(b_prepared) if np.isscalar(b_prepared)
                else a * b_prepared) % self.p
        return prod * self.rinv % self.p if self.mont else prod


def dif_regs(r, s, off, f, field, inverse):
    """regstages.cuh dif_regs: in-place radix-2 DIF of r[off:off+s]."""
    h = s // 2
    while h >= 1:
        for bt in range(s // 2):
            j = bt % h
            i0 = off + bt // h * 2 * h + j
            u, v = r[i0], r[i0 + h]
            r[i0] = f.add(u, v)
            d = f.sub(u, v)
            r[i0 + h] = d if j == 0 else f.mul(d, root_pow(field, inverse,
                                                           2 * h, j))
        h //= 2


def kernel_model(x, field, inverse, post=None, mask=None, orig=None):
    """row.cu's row_kernel on one column b of [A, B = 1, L], every lane
    tile, every thread, with its shared-memory index maps; with ``post``
    ([A], the column's table row), row_post_kernel (K7); with ``post``,
    ``mask`` ([A]) and ``orig`` ([A, L]), row_sel_kernel (K7-sel)."""
    a = x.shape[0]
    sel = mask is not None
    la = a.bit_length() - 1
    a1, a2 = m._row_split(a)
    la1, la2 = la - la // 2, la // 2
    tl = min(16384 // a, 32)            # RegSplit::kTileWords / A
    row_words = (a1 + 1) * tl
    exch = a2 * row_words
    smem_words = exch + a2 * (a1 + 1)
    post_off, mask_off = smem_words, smem_words + a
    f = Arith(field)
    lanes = x.shape[1]
    out = np.zeros_like(x)
    tw = m._row_inner_twiddles(field.name, a, inverse).reshape(-1)
    t = np.arange(a2)[:, None]             # thread = (t, l), [A2, TL]
    l = np.arange(tl)[None, :]
    for l0 in range(0, lanes, tl):
        rows_after = 2 if sel else 1 if post is not None else 0
        smem = np.zeros(smem_words + rows_after * a, np.uint64)
        # the loads: tile[a * TL + l], lanes past L zero-filled
        cols = np.arange(l0, l0 + tl)
        tile = np.zeros((a, tl), np.uint64)
        tile[:, cols < lanes] = x[:, cols[cols < lanes]]
        smem[:a * tl] = tile.reshape(-1)
        e = np.arange(a)
        smem[exch + e // a1 * (a1 + 1) + e % a1] = tw
        if post is not None:
            smem[post_off:post_off + a] = post
        if sel:
            smem[mask_off:mask_off + a] = mask
        # step 1: column n2 = t at stride A2, all threads read, then DIF
        r = [smem[(n1 * a2 + t) * tl + l] for n1 in range(a1)]
        dif_regs(r, a1, 0, f, field, inverse)
        # the inner twiddles into exchange row t (after the barrier)
        for k1 in range(a1):
            v = r[bitrev(k1, la1)]
            if k1:
                v = f.mul(v, smem[exch + t * (a1 + 1) + k1])
            smem[t * row_words + k1 * tl + l] = v
        # step 2: columns k1 = t + A2 j
        r = [None] * a1
        for j in range(a1 // a2):
            for n2 in range(a2):
                r[j * a2 + n2] = smem[(t + a2 * j) * tl + l + n2 * row_words]
            dif_regs(r, a2, j * a2, f, field, inverse)
        # the store: out[k1 + A1 k2, l0 + l] = r[j * A2 + bitrev(k2)];
        # K7: x post[k]; K7-sel: x post[k] where mask[k] != 0, else
        # orig[k, l0 + l]
        live = (l0 + l < lanes)[0]
        for j in range(a1 // a2):
            for k2 in range(a2):
                rows = (t + a2 * j + k2 * a1)[:, 0]
                val = r[j * a2 + bitrev(k2, la2)]
                if sel:
                    keep = smem[mask_off + rows] != 0
                    mul = f.mul(val, smem[post_off + rows][:, None])
                    kept = np.zeros_like(val)
                    kept[:, live] = orig[rows[:, None], (l0 + l)[:, live]]
                    val = np.where(keep[:, None], mul, kept)
                elif post is not None:
                    val = f.mul(val, smem[post_off + rows][:, None])
                out[rows[:, None], (l0 + l)[:, live]] = val[:, live]
    return out.astype(np.uint32)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_compile_time_constants_are_the_stage_tables(field):
    """The constants regstages.cuh computes at compile time (root_pow) are
    ntt._stage_twiddles' values at every sub-transform size the split
    uses (2 .. 32), both directions."""
    for order in (2, 4, 8, 16, 32):
        for inverse in (False, True):
            want = _stage_twiddles(field.name, order, inverse)
            got = [root_pow(field, inverse, order, j)
                   for j in range(order // 2)]
            np.testing.assert_array_equal(np.array(got, np.uint32), want)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_split_and_inner_twiddles(field):
    """A1 * A2 = A with both factors <= 32 and A1 in {A2, 2 A2}; the inner
    table is w_A^(n2 k1) (inverse: w_A^-(n2 k1)), prepared."""
    for la in range(1, 11):
        a = 1 << la
        a1, a2 = m._row_split(a)
        assert a1 * a2 == a and a1 <= 32 and a1 in (a2, 2 * a2)
        for inverse in (False, True):
            tw = m._row_inner_twiddles(field.name, a, inverse)
            assert tw.shape == (a2, a1) and tw.dtype == np.uint32
            for n2, k1 in ((0, 0), (a2 - 1, a1 - 1), (a2 // 2, 1)):
                assert tw[n2, k1] == root_pow(field, inverse, a, n2 * k1)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("la", range(1, 11))
def test_schedule_matches_reference(la, field, inverse):
    """The kernel's schedule == the JAX package's staged transform
    (unscaled), bit for bit, at A = 2^la over 13 lanes."""
    a = 1 << la
    rng = np.random.default_rng(0x5C4ED + 4 * la + 2 * field.use_mont
                                + inverse)
    x = rng.integers(0, field.p, size=(a, LANES), dtype=np.uint64).astype(
        np.uint32)
    if not field.use_mont:
        x[rng.random((a, LANES)) < 0.1] = 0x10000
    want = np.asarray(jntt(jnp.asarray(x), field=jfields.FIELDS[field.name],
                           inverse=inverse, scale=False))
    np.testing.assert_array_equal(kernel_model(x, field, inverse), want)


def sel_model(y, field, inverse, vec, mask, orig):
    """K7-sel on [A, B, L]: row_sel_kernel's blocks, column b with its
    table rows vec[k * B + b] and mask[k * B + b]."""
    a, nb, _ = y.shape
    v, mk = vec.reshape(a, nb), mask.reshape(a, nb)
    return np.stack([kernel_model(y[:, b], field, inverse, v[:, b], mk[:, b],
                                  orig[:, b]) for b in range(nb)], axis=1)


def ref_sel(y, field, inverse, vec, mask, orig):
    """K7-sel from the JAX package: the staged transform along axis 0, x
    the table, then the row select where(mask != 0, ., orig)."""
    jf = jfields.FIELDS[field.name]
    a, nb, lanes = y.shape
    t = jntt(jnp.asarray(y.reshape(a, nb * lanes)), field=jf,
             inverse=inverse, scale=False).reshape(a, nb, lanes)
    t = jmul(jf, t, jnp.asarray(vec).reshape(a, nb, 1))
    keep = jnp.asarray(mask).reshape(a, nb, 1) != 0
    return np.asarray(jnp.where(keep, t, jnp.asarray(orig)))


MASKS = ["none", "all", "half", "half_alias"]


def sel_case(la, field, inverse, masks):
    """K7-sel's operands at A = 2^la over [A, 3, 13]: the pass input, a
    prepared table (GF16: 0x10000 at every 5th row, as inv(x l') can be
    p - 1), a mask of kind ``masks`` and an original (the input itself
    for "half_alias")."""
    a = 1 << la
    rng = np.random.default_rng(0x5E1 + 4 * la + 2 * field.use_mont
                                + inverse)
    shape = (a, COLS, LANES)
    y = rng.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)
    vec = rng.integers(0, field.p, size=a * COLS, dtype=np.uint64).astype(
        np.uint32)
    if not field.use_mont:
        vec[::5] = 0x10000
    orig = rng.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)
    if masks == "none":
        mask = np.zeros(a * COLS, np.uint32)
    elif masks == "all":
        # any value but 0 selects: ones and values whose low byte is 0
        mask = np.where(rng.random(a * COLS) < 0.5, 1, 0x100).astype(
            np.uint32)
    else:
        mask = (rng.random(a * COLS) < 0.5).astype(np.uint32)
    if masks == "half_alias":
        orig = y
    return y, vec, mask, orig


@pytest.mark.parametrize("masks", MASKS)
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("la", range(1, 11))
def test_sel_schedule_matches_reference(la, field, inverse, masks):
    """K7-sel's schedule == the JAX package's staged transform, table
    multiply and row select, bit for bit, at A = 2^la over [A, 3, 13]:
    masks all 0 (every row the original), all set (every row multiplied;
    values 1 and 0x100), about half set, and half set with the original
    the pass's own input."""
    y, vec, mask, orig = sel_case(la, field, inverse, masks)
    got = sel_model(y, field, inverse, vec, mask, orig)
    np.testing.assert_array_equal(
        got, ref_sel(y, field, inverse, vec, mask, orig))
    if masks == "none":
        np.testing.assert_array_equal(got, orig)


def post_model(y, field, inverse, vec):
    """K7 on [A, B, L]: row_post_kernel's blocks, column b with its table
    row vec[k * B + b]."""
    a, nb, _ = y.shape
    v = vec.reshape(a, nb)
    return np.stack([kernel_model(y[:, b], field, inverse, v[:, b])
                     for b in range(nb)], axis=1)


def ref_post(y, field, inverse, vec):
    """K7 from the JAX package: the staged transform along axis 0, x the
    table."""
    jf = jfields.FIELDS[field.name]
    a, nb, lanes = y.shape
    t = jntt(jnp.asarray(y.reshape(a, nb * lanes)), field=jf,
             inverse=inverse, scale=False).reshape(a, nb, lanes)
    return np.asarray(jmul(jf, t, jnp.asarray(vec).reshape(a, nb, 1)))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("la", range(1, 11))
def test_post_schedule_matches_reference(la, field, inverse):
    """K7's schedule (K3's with the table row copied in beside the tile and
    every row multiplied in the store) == the JAX package's staged
    transform times the table, bit for bit, at A = 2^la over [A, 3, 13];
    GF16 tables hold 0x10000 at every 7th row and the input 0x10000 at
    about a tenth of its elements."""
    a = 1 << la
    rng = np.random.default_rng(0x7057 + 4 * la + 2 * field.use_mont
                                + inverse)
    shape = (a, COLS, LANES)
    y = rng.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)
    vec = rng.integers(0, field.p, size=a * COLS, dtype=np.uint64).astype(
        np.uint32)
    if not field.use_mont:
        y[rng.random(shape) < 0.1] = 0x10000
        vec[::7] = 0x10000
    np.testing.assert_array_equal(post_model(y, field, inverse, vec),
                                  ref_post(y, field, inverse, vec))
