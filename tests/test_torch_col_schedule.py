"""K1's, K2's, K4's, K5's, K6's and K8's schedules against the reference,
on the CPU.

Pass A (K1), pass A with an input multiply (K4: the rank-1 g^m; K5: a
table row), the encode seam (K2) and the decode seam (K6) are one kernel
template in ``fastecc_tpu_torch/csrc/col.cu`` on ``csrc/regstages.cuh``;
it cannot run here, so this file models its exact schedule in numpy: the
[A, TL] tile in a flat shared-memory buffer per block, the per-row factors
the block computes from the four-step seeds (and, for K2 and K4, the
rank-1 row pcol[k] * prow[b]; for K5 and K6, the table's column
v[k * B + b] copied in with the tile), K4's and K5's multiply as step 1
reads the tile, the A1-point in-register DIF with its
compile-time constants, the inner twiddles from ``_row_inner_twiddles``
staged into padded rows, the exchange, the A2-point DIFs, the seam's
register-resident hand-off into its second transform and the transposed
store from registers, with the same index maps and butterfly order.

K8 (the GF16 wire pair's pass A1) is K1's GF16 kernel (inverse, scaled)
on both halves of the pairs in one block: step 1 splits each tile word
into lo = x & 0xFFFF and hi = x >> 16 on its way into two register
arrays, then lo's transform runs (its exchange overwriting the tile) and
hi's after it, and both are stored. K9 (the wire pair's seam) is K2's
kernel launched once on each half of the [2, R1, C1, Wu] pair; its model
is K2's on each half.

The model is held bit for bit against the JAX package's staged transform
plus its four-step twiddle tables at every A = 2 .. 1024 in both fields
(K1, K4 and K5 forward, scaled inverse and unscaled inverse, K4 and K5 on
the input pre-multiplied in JAX; K2; K5 and K6 with GF16 tables holding
0x10000; K8 on full-range u32 pairs against the scaled inverse pass on
each half), on ragged lanes, and chained with K3's, K7's and K7-sel's
models (``tests/test_torch_row_schedule.py``) against the Pallas passes
in interpret mode: the single transform after K1's and K4's model, the
encode pair after K1's, the decode pair (with and without the merge)
after K5's, the GF16 wire pair after K8's. The kernel itself is
held against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fastecc_tpu import fields as jfields
from fastecc_tpu.kernels import ntt_mfa as jmfa
from fastecc_tpu.ntt import mul_prepared as jmul
from fastecc_tpu.ntt import ntt_jit as jntt
from fastecc_tpu_torch import fields
from fastecc_tpu_torch.kernels import ntt_mfa as m

from test_torch_row_schedule import (Arith, bitrev, dif_regs, post_model,
                                     sel_model)
from test_torch_row_schedule import kernel_model as row_model

FIELDS = [fields.GF32, fields.GF16]
LANES = 13          # ragged: not a multiple of 4 nor of any lane tile
COLS = 4            # B: two seed columns (tr = 2) and two t0 rows
SMEM_BYTES = 232448  # what one block may use on the H100


def geometry(a):
    """col.cu's compile-time shape of an a-point block (RegSplit)."""
    la = a.bit_length() - 1
    a1, a2 = m._row_split(a)
    tl = min(16384 // a, 32)
    return dict(la1=la - la // 2, la2=la // 2, a1=a1, a2=a2, tl=tl,
                row_words=(a1 + 1) * tl, exch=a2 * (a1 + 1) * tl,
                tw_words=a2 * (a1 + 1))


def smem_words(a, seam, row=None):
    """col.cu smem_words: exchange, inner tables (two in a seam), T's
    row, the second factor row (the seam's middle, K4's and K5's
    input)."""
    g = geometry(a)
    row = seam if row is None else row
    return (g["exch"] + (2 if seam else 1) * g["tw_words"]
            + (2 if row else 1) * a)


def col_model(x, field, inverse=False, scale=True, seam_g=None,
              seam_vec=None, pre_g=None, pre_vec=None, wire16=False):
    """col.cu's col_kernel on x [A, B, L] -> [B, A, L]: every block
    (column b, lane tile) and every thread (t, l) at once, with the
    kernel's shared-memory index maps. ``seam_g``: K2 with the coset
    powers of seam_g (first transform inverse, second forward);
    ``seam_vec``: K6, the same with the middle factors v[k * B + b] of a
    prepared [A * B] table. ``pre_g``: K4, K1 after x[k, b] *= pre_g^(b +
    B k) from the rank-1 tables; ``pre_vec``: K5, K1 after x[k, b] *=
    v[k * B + b]. ``wire16``: K8, K1 on lo = x & 0xFFFF and on hi =
    x >> 16 of the u32 pairs x, both read at step 1 and transformed in
    turn through the one exchange -> [2, B, A, L]."""
    a, nb, lanes = x.shape
    g = geometry(a)
    a1, a2, tl = g["a1"], g["a2"], g["tl"]
    row_words, exch, kt = g["row_words"], g["exch"], g["tw_words"]
    seam = seam_g is not None or seam_vec is not None
    pre = pre_g is not None or pre_vec is not None
    tr = m._seed_tr(nb)
    f = Arith(field)
    inv1 = True if seam else inverse
    seed, t0 = m._colpass_seeds(field.name, a * nb, a,
                                False if seam else inverse,
                                False if seam else scale, tr)
    seed, t0 = seed.reshape(-1).astype(np.uint64), t0.reshape(-1)
    tw_off = [exch, exch + kt]
    fac_off = exch + (2 if seam else 1) * kt
    mid_off = fac_off + a
    blk = np.arange(nb)[:, None, None]          # block's column b
    t = np.arange(a2)[None, :, None]            # thread = (t, l)
    l = np.arange(tl)[None, None, :]
    out = np.zeros((2 if wire16 else 1, nb, a, lanes), np.uint64)

    def sm(idx):
        return smem[blk, idx]

    def transform_regs(r, tw, inv):
        """regstages.cuh reg_transform_regs; returns the new registers."""
        dif_regs(r, a1, 0, f, field, inv)
        for k1 in range(a1):
            v = r[bitrev(k1, g["la1"])]
            if k1:
                v = f.mul(v, sm(tw + t * (a1 + 1) + k1))
            smem[blk, t * row_words + k1 * tl + l] = v
        r = [None] * a1
        for j in range(a1 // a2):
            for n2 in range(a2):
                r[j * a2 + n2] = sm((t + a2 * j) * tl + l + n2 * row_words)
            dif_regs(r, a2, j * a2, f, field, inv)
        return r

    for l0 in range(0, lanes, tl):
        smem = np.zeros((nb, smem_words(a, seam, seam or pre)), np.uint64)
        # the copies: tile[a * TL + l], lanes past L zero-filled; the
        # inner tables into rows of A1 + 1 words
        cols = np.arange(l0, l0 + tl)
        tile = np.zeros((a, nb, tl), np.uint64)
        tile[:, :, cols < lanes] = x[:, :, cols[cols < lanes]]
        smem[:, :a * tl] = tile.transpose(1, 0, 2).reshape(nb, -1)
        e = np.arange(a)
        smem[:, tw_off[0] + e // a1 * (a1 + 1) + e % a1] = \
            m._row_inner_twiddles(field.name, a, inv1).reshape(-1)
        # the per-row factors: T[k, b] = seed[k, b mod tr] * t0[b / tr, k]
        k = np.arange(a)[None, :]
        b = np.arange(nb)[:, None]
        smem[:, fac_off:fac_off + a] = f.mul(seed[k * tr + (b & (tr - 1))],
                                             t0[(b // tr) * a + k])
        if seam:
            smem[:, tw_off[1] + e // a1 * (a1 + 1) + e % a1] = \
                m._row_inner_twiddles(field.name, a, False).reshape(-1)
        vec = seam_vec if seam_vec is not None else pre_vec
        rank1 = seam_g if seam_g is not None else pre_g
        if vec is not None:
            # block b's copies: mid[k] = v[k * B + b]
            smem[:, mid_off:mid_off + a] = vec.astype(np.uint64)[k * nb + b]
        elif rank1 is not None:
            pcol, prow = m._pre_mul_tables(field.name, rank1 % field.p, a,
                                           nb, tr)
            smem[:, mid_off:mid_off + a] = f.mul(
                pcol.astype(np.uint64)[None, :], prow.reshape(-1)[:, None])
        # step 1 of the first transform: column n2 = t at stride A2; K4
        # and K5 multiply each element by its row's factor on the way in
        r = [sm((n1 * a2 + t) * tl + l) for n1 in range(a1)]
        if wire16:
            # K8: both halves into registers before lo's exchange
            hi = [v >> np.uint64(16) for v in r]
            r = [v & np.uint64(0xFFFF) for v in r]
        if pre:
            r = [f.mul(r[n1], sm(mid_off + n1 * a2 + t)) for n1 in range(a1)]
        r = transform_regs(r, tw_off[0], inv1)
        if wire16:
            # hi's transform reuses the exchange after lo's last reads
            hi = transform_regs(hi, tw_off[0], inv1)
        if seam:
            # the hand-off: n1 = j + (A1 / A2) k2 is in r[j A2 + bitrev(k2)]
            rho = a1 // a2
            r = [f.mul(r[n1 % rho * a2 + bitrev(n1 // rho, g["la2"])],
                       sm(mid_off + t + a2 * n1)) for n1 in range(a1)]
            r = transform_regs(r, tw_off[1], False)
        halves = [r, hi] if wire16 else [r]
        # the store: out[b, k1 + A1 k2, l0 + l] = r[j A2 + bitrev(k2)] x T
        # (K8: lo into half 0, hi into half 1)
        live = (l0 + l < lanes)[0, 0]
        for h, regs in enumerate(halves):
            for j in range(a1 // a2):
                for k2 in range(a2):
                    kk = t + a2 * j + a1 * k2
                    v = f.mul(regs[j * a2 + bitrev(k2, g["la2"])],
                              sm(fac_off + kk))
                    out[h, blk, kk, (l0 + l)[:, :, live]] = v[:, :, live]
    return (out if wire16 else out[0]).astype(np.uint32)


def j_twiddle(y, jf, n, c, inverse, scale):
    """y [C, R, L] x T[k, r] from the JAX package's seed tables (at the
    port's seed width)."""
    r = n // c
    tr = m._seed_tr(r)
    seed, t0 = jmfa._colpass_seeds(jf.name, n, c, inverse, scale, tr)
    cols = np.arange(r)
    tt = jmul(jf, jnp.asarray(seed[:, cols % tr]),
              jnp.asarray(np.asarray(t0).T[:, cols // tr]))
    return jmul(jf, y, tt[:, :, None])


def j_stages(y, jf, inverse):
    a, nb, lanes = y.shape
    return jntt(y.reshape(a, nb * lanes), field=jf, inverse=inverse,
                scale=False).reshape(a, nb, lanes)


def ref_col(x, field, inverse, scale, pre=None):
    """Pass A from the JAX package: (x pre[k, b] if given, a [A, B] jnp
    array of prepared factors,) staged transform, twiddle, transpose."""
    jf = jfields.FIELDS[field.name]
    a, nb, _ = x.shape
    x = jnp.asarray(x)
    if pre is not None:
        x = jmul(jf, x, pre[:, :, None])
    y = j_twiddle(j_stages(x, jf, inverse), jf, a * nb, a, inverse, scale)
    return np.asarray(jnp.transpose(y, (1, 0, 2)))


def j_rank1(field, g, a, nb):
    """The JAX package's rank-1 g^(b + B k) over [A, B] (its pre tables
    at the port's seed width)."""
    jf = jfields.FIELDS[field.name]
    pcol, prow = jmfa._pre_mul_tables(jf.name, g % field.p, a, nb,
                                      m._seed_tr(nb))
    return jmul(jf, jnp.asarray(pcol)[:, None],
                jnp.asarray(prow).reshape(1, -1))


def ref_seam(x, field, g):
    """The seam from the JAX package: inverse stages, x g^m, forward
    stages, twiddle, transpose (C2 = R1 = A, R2 = C1 = B)."""
    jf = jfields.FIELDS[field.name]
    a, nb, _ = x.shape
    pre = j_rank1(field, g, a, nb)
    y = jmul(jf, j_stages(jnp.asarray(x), jf, True), pre[:, :, None])
    y = j_twiddle(j_stages(y, jf, False), jf, a * nb, a, False, False)
    return np.asarray(jnp.transpose(y, (1, 0, 2)))


def ref_seam_vec(x, field, vec):
    """K6 from the JAX package: inverse stages, x v[k * B + b], forward
    stages, twiddle, transpose."""
    jf = jfields.FIELDS[field.name]
    a, nb, _ = x.shape
    y = jmul(jf, j_stages(jnp.asarray(x), jf, True),
             jnp.asarray(vec).reshape(a, nb, 1))
    y = j_twiddle(j_stages(y, jf, False), jf, a * nb, a, False, False)
    return np.asarray(jnp.transpose(y, (1, 0, 2)))


def rand_table(field, n, seed):
    """A prepared [n] table; GF16 ones hold 0x10000 at every 5th entry."""
    v = rand_input(field, (n,), seed)
    if not field.use_mont:
        v[::5] = 0x10000
    return v


def rand_input(field, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)
    if not field.use_mont:
        x[rng.random(shape) < 0.1] = 0x10000
    return x


@pytest.mark.parametrize("la", range(1, 11))
def test_handoff_is_the_second_transforms_column(la):
    """After the first transform thread t holds k = t + A2 j + A1 k2 in
    r[j A2 + bitrev(k2)]: exactly the A1 elements t + A2 n1 of column
    n2 = t, each once, with n1 = j + (A1 / A2) k2. And the seam's block
    (the largest) fits twice in an SM's shared memory."""
    a = 1 << la
    g = geometry(a)
    a1, a2 = g["a1"], g["a2"]
    rho = a1 // a2
    for t in range(a2):
        held = {}
        for j in range(rho):
            for k2 in range(a2):
                reg = j * a2 + bitrev(k2, g["la2"])
                held[reg] = t + a2 * j + a1 * k2
        assert sorted(held) == list(range(a1))
        for n1 in range(a1):
            assert held[n1 % rho * a2 + bitrev(n1 // rho, g["la2"])] == \
                t + a2 * n1
    assert 2 * 4 * smem_words(a, True) <= SMEM_BYTES
    assert a2 * g["tl"] <= 512          # threads a block


@pytest.mark.parametrize("mode", ["fwd", "inv_scaled", "inv"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("la", range(1, 11))
def test_col_schedule_matches_reference(la, field, mode):
    """K1's schedule == the JAX package's staged transform x its
    four-step twiddle, transposed, bit for bit, at A = 2^la over
    [A, 4, 13]."""
    a = 1 << la
    inverse, scale = mode != "fwd", mode == "inv_scaled"
    x = rand_input(field, (a, COLS, LANES),
                   0xC01 + 8 * la + 2 * field.use_mont + inverse + 4 * scale)
    np.testing.assert_array_equal(col_model(x, field, inverse, scale),
                                  ref_col(x, field, inverse, scale))


@pytest.mark.parametrize("mode", ["fwd", "inv_scaled", "inv"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("la", range(1, 11))
def test_col_pre_schedule_matches_reference(la, field, mode):
    """K4's schedule (K1's with the rank-1 row at step 1's loads) == the
    JAX package's staged transform of x g^m (its own pre tables), x its
    four-step twiddle, transposed, bit for bit, at A = 2^la over
    [A, 4, 13]; g of order 4A, so GF16's tables hold 0x10000."""
    a = 1 << la
    inverse, scale = mode != "fwd", mode == "inv_scaled"
    x = rand_input(field, (a, COLS, LANES),
                   0xC04 + 8 * la + 2 * field.use_mont + inverse + 4 * scale)
    g = field.root_of_order(a * COLS)
    np.testing.assert_array_equal(
        col_model(x, field, inverse, scale, pre_g=g),
        ref_col(x, field, inverse, scale, j_rank1(field, g, a, COLS)))


@pytest.mark.parametrize("mode", ["fwd", "inv_scaled", "inv"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("la", range(1, 11))
def test_col_vec_schedule_matches_reference(la, field, mode):
    """K5's schedule (K1's with the table's column copied in beside the
    tile and applied at step 1's loads) == the JAX package's staged
    transform of x v[k * B + b], x its four-step twiddle, transposed, bit
    for bit, at A = 2^la over [A, 4, 13]; GF16 tables hold 0x10000."""
    a = 1 << la
    inverse, scale = mode != "fwd", mode == "inv_scaled"
    x = rand_input(field, (a, COLS, LANES),
                   0xC05 + 8 * la + 2 * field.use_mont + inverse + 4 * scale)
    vec = rand_table(field, a * COLS, 0x7A5 + 4 * la + inverse + 2 * scale)
    np.testing.assert_array_equal(
        col_model(x, field, inverse, scale, pre_vec=vec),
        ref_col(x, field, inverse, scale, jnp.asarray(vec).reshape(a, COLS)))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("la", range(1, 11))
def test_seam_schedule_matches_reference(la, field):
    """K2's schedule (the register hand-off between its transforms
    included) == the JAX package's inverse stages, coset multiply,
    forward stages and twiddle, transposed, bit for bit, at A = 2^la over
    [A, 4, 13]."""
    a = 1 << la
    x = rand_input(field, (a, COLS, LANES), 0x5EA + 4 * la + field.use_mont)
    g = field.root_of_order(2 * a * COLS)
    np.testing.assert_array_equal(col_model(x, field, seam_g=g),
                                  ref_seam(x, field, g))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("la", range(1, 11))
def test_seam_vec_schedule_matches_reference(la, field):
    """K6's schedule (K2's with the middle row from the table) == the JAX
    package's inverse stages, table multiply, forward stages and twiddle,
    transposed, bit for bit, at A = 2^la over [A, 4, 13]; GF16 tables hold
    0x10000."""
    a = 1 << la
    x = rand_input(field, (a, COLS, LANES), 0x5EB + 4 * la + field.use_mont)
    vec = rand_table(field, a * COLS, 0x7AB + la)
    np.testing.assert_array_equal(col_model(x, field, seam_vec=vec),
                                  ref_seam_vec(x, field, vec))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("n", [1 << 7, 1 << 10])
def test_chained_decode_models_match_pallas_interpret(field, n):
    """The decode pair as the port chains it, K5's model -> K6's model ->
    K7-sel's model (the original the pass-A input, as in
    decode_prepared), == ntt_pair_pallas with the same tables and merge
    in interpret mode, over 128 lanes; about half the rows erased."""
    lanes = 128
    x = rand_input(field, (n, lanes), 0xDEC + n + field.use_mont)
    v1, v2, v3 = (rand_table(field, n, 0x7AB + n + i) for i in range(3))
    mask = (np.random.default_rng(n).random(n) < 0.5).astype(np.uint32)
    c1 = m._pair_split(n)
    x3 = x.reshape(c1, n // c1, lanes)
    col1 = col_model(x3, field, True, True, pre_vec=v1)
    col2 = col_model(col1, field, seam_vec=v2)
    got = sel_model(col2, field, False, v3, mask, x3)
    rf = jfields.FIELDS[field.name]
    want = np.asarray(jmfa.ntt_pair_pallas(
        jnp.asarray(x), rf, pre_vec1=jnp.asarray(v1),
        pre_vec2=jnp.asarray(v2), post_vec=jnp.asarray(v3),
        sel_mask=jnp.asarray(mask), sel_orig=jnp.asarray(x), interpret=True,
        tile=(8, 128)))
    np.testing.assert_array_equal(got.reshape(n, lanes), want)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("n", [1 << 7, 1 << 10])
def test_chained_models_match_pallas_interpret(field, n):
    """The models chained as the port chains the kernels == the Pallas
    passes in interpret mode: K1 -> K3 (forward; the scaled inverse at
    2^7) against ntt_pallas, K1 -> K2 -> K3 against ntt_coset_pair_pallas,
    over 128 lanes."""
    lanes = 128
    x = rand_input(field, (n, lanes), 0xC4A + n + field.use_mont)
    jx, rf = jnp.asarray(x), jfields.FIELDS[field.name]
    c = m._split(n)
    for inverse in (False, True) if n == 1 << 7 else (False,):
        col = col_model(x.reshape(c, n // c, lanes), field, inverse, True)
        got = row_model(col.reshape(n // c, c * lanes), field, inverse)
        want = np.asarray(jmfa.ntt_pallas(jx, rf, inverse=inverse,
                                          interpret=True))
        np.testing.assert_array_equal(got.reshape(n, lanes), want)
    g = field.root_of_order(2 * n)
    c1 = m._pair_split(n)
    col1 = col_model(x.reshape(c1, n // c1, lanes), field, True, True)
    col2 = col_model(col1, field, seam_g=g)
    got = row_model(col2.reshape(c1, (n // c1) * lanes), field, False)
    want = np.asarray(jmfa.ntt_coset_pair_pallas(jx, rf, g, interpret=True,
                                                 tile=(8, 128)))
    np.testing.assert_array_equal(got.reshape(n, lanes), want)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_chained_pre_models_match_pallas_interpret(field):
    """K4's model -> K3's model, as ntt_fused chains them for a coset
    transform (x[m] *= g^m fused into pass A), == ntt_pallas(pre_seed=g)
    in interpret mode at n = 2^10 over 128 lanes."""
    n, lanes = 1 << 10, 128
    x = rand_input(field, (n, lanes), 0xC4B + field.use_mont)
    g = field.root_of_order(4 * n)
    c = m._split(n)
    col = col_model(x.reshape(c, n // c, lanes), field, pre_g=g)
    got = row_model(col.reshape(n // c, c * lanes), field, False)
    want = np.asarray(jmfa.ntt_pallas(jnp.asarray(x),
                                      jfields.FIELDS[field.name],
                                      pre_seed=g, interpret=True))
    np.testing.assert_array_equal(got.reshape(n, lanes), want)


@pytest.mark.parametrize("la", range(1, 11))
def test_seam_wire16_halves_match_reference(la):
    """K9's schedule, K2's on each half of the wire pair's [2, R1, C1, Wu]
    (GF16, Wu = 8: whole bitmap groups), == the JAX package's seam on that
    half, bit for bit, at R1 = 2^la; and the port's K9 wrapper on the CPU
    (its plain version) gives the same halves."""
    from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
    a, f = 1 << la, fields.GF16
    y = np.stack([rand_input(f, (a, COLS, 8), 0x9E + 4 * la + h)
                  for h in (0, 1)])
    g = f.root_of_order(2 * a * COLS)
    got = np.stack([col_model(h, f, seam_g=g) for h in y])
    for h in (0, 1):
        np.testing.assert_array_equal(got[h], ref_seam(y[h], f, g))
    np.testing.assert_array_equal(to_numpy_u32(m.seam_pass_wire16(
        from_numpy_u32(y, "cpu"), f, g)), got)


@pytest.mark.parametrize("k", [1 << 7, 1 << 10])
def test_wire16_pair_with_seam_model_matches_pallas_interpret(k):
    """The GF16 wire pair as the port runs it, plain K8 -> K9's model (K2's
    on each half) -> plain K10, == ntt_coset_pair_wire16_pallas in
    interpret mode over 128 pair lanes of random wire words."""
    from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
    f = fields.GF16
    pairs = np.random.default_rng(0x9A + k).integers(
        0, 1 << 32, size=(k, 128), dtype=np.uint64).astype(np.uint32)
    g = f.root_of_order(2 * k)
    c1 = m._pair_split(k)
    h1 = to_numpy_u32(m.col_pass_wire16(
        from_numpy_u32(pairs.reshape(c1, k // c1, 128), "cpu"), f))
    h2 = [from_numpy_u32(col_model(h, f, seam_g=g), "cpu") for h in h1]
    got = m.wire16_pass_b2(h2[0], h2[1], f)
    want = jmfa.ntt_coset_pair_wire16_pallas(
        jnp.asarray(pairs), jfields.GF16, g, interpret=True, tile=(8, 128))
    for a_, b_ in zip(got, want):
        np.testing.assert_array_equal(to_numpy_u32(a_), np.asarray(b_))


@pytest.mark.parametrize("la", range(1, 11))
def test_col_wire16_schedule_matches_reference(la):
    """K8's schedule (K1's GF16 block on both halves of the pairs, split
    at step 1's reads, transformed in turn) on random full-range u32 pairs
    ==
    the JAX package's scaled inverse pass A on x & 0xFFFF (half 0) and on
    x >> 16 (half 1), bit for bit, at C1 = 2^la over [C1, 4, 13]; and the
    port's K8 wrapper on the CPU (its plain version) gives the same
    [2, R1, C1, L]."""
    from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
    a, f = 1 << la, fields.GF16
    x = np.random.default_rng(0x8C + la).integers(
        0, 1 << 32, size=(a, COLS, LANES), dtype=np.uint64).astype(np.uint32)
    got = col_model(x, f, True, True, wire16=True)
    for h, part in enumerate((x & 0xFFFF, x >> 16)):
        np.testing.assert_array_equal(got[h], ref_col(part, f, True, True))
    np.testing.assert_array_equal(to_numpy_u32(m.col_pass_wire16(
        from_numpy_u32(x, "cpu"), f)), got)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("n", [1 << 7, 1 << 10])
def test_chained_decode_post_models_match_pallas_interpret(field, n):
    """The decode pair without the merge (decode_prepared(merge=False)),
    K5's model -> K6's model -> K7's model, == ntt_pair_pallas with the
    same tables and post_vec, no select, in interpret mode over 128
    lanes."""
    lanes = 128
    x = rand_input(field, (n, lanes), 0xDED + n + field.use_mont)
    v1, v2, v3 = (rand_table(field, n, 0x7AC + n + i) for i in range(3))
    c1 = m._pair_split(n)
    col1 = col_model(x.reshape(c1, n // c1, lanes), field, True, True,
                     pre_vec=v1)
    col2 = col_model(col1, field, seam_vec=v2)
    got = post_model(col2, field, False, v3)
    want = np.asarray(jmfa.ntt_pair_pallas(
        jnp.asarray(x), jfields.FIELDS[field.name], pre_vec1=jnp.asarray(v1),
        pre_vec2=jnp.asarray(v2), post_vec=jnp.asarray(v3), interpret=True,
        tile=(8, 128)))
    np.testing.assert_array_equal(got.reshape(n, lanes), want)


@pytest.mark.parametrize("k", [1 << 7, 1 << 10])
def test_wire16_pair_from_col_model_matches_pallas_interpret(k):
    """The GF16 wire pair as the port runs it from K8 on, K8's model (both
    halves) -> K9's model (K2's on each half) -> plain K10, ==
    ntt_coset_pair_wire16_pallas in interpret mode over 128 pair lanes of
    random wire words."""
    from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
    f = fields.GF16
    pairs = np.random.default_rng(0x8A + k).integers(
        0, 1 << 32, size=(k, 128), dtype=np.uint64).astype(np.uint32)
    g = f.root_of_order(2 * k)
    c1 = m._pair_split(k)
    x3 = pairs.reshape(c1, k // c1, 128)
    h2 = [from_numpy_u32(col_model(h, f, seam_g=g), "cpu")
          for h in col_model(x3, f, True, True, wire16=True)]
    got = m.wire16_pass_b2(h2[0], h2[1], f)
    want = jmfa.ntt_coset_pair_wire16_pallas(
        jnp.asarray(pairs), jfields.GF16, g, interpret=True, tile=(8, 128))
    for a_, b_ in zip(got, want):
        np.testing.assert_array_equal(to_numpy_u32(a_), np.asarray(b_))
