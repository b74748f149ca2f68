"""Port vs reference: unknown-position error correction
(fastecc_tpu_torch.decode.locate_errors / correct_errors /
decode_blocks(check=True) vs fastecc_tpu.decode).

The scenarios are tests/test_decode.py's. Same numpy inputs (from a seed)
and the same ``entropy`` through both packages on the CPU, where the
port's pass wrappers run their plain versions; every comparison is exact
(tolerance 0: integer arithmetic), so the random lane combinations, the
syndromes and the located positions agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastecc_tpu import decode as jdec
from fastecc_tpu import fields as jfields
from fastecc_tpu import rs as jrs
from fastecc_tpu_torch import decode as dec
from fastecc_tpu_torch import fields, rs
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32

torch.set_num_threads(1)

RNG = np.random.default_rng(0xE5505)
FIELDS = [fields.GF32, fields.GF16]
GF32 = fields.GF32


def _ref(field):
    return jfields.FIELDS[field.name]


def rand_field(field, shape, rng=RNG):
    return rng.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)


def encode(field, k, n, lanes):
    data = rand_field(field, (k, lanes))
    return np.array(jrs.encode_jit(jnp.asarray(data), _ref(field), n))


def t(a):
    return from_numpy_u32(np.asarray(a, np.uint32), "cpu")


def both_correct(bad, k, field, erased=None, entropy=7):
    """(port, reference) results of correct_errors on the same input; the
    port's corrected codeword as numpy."""
    fixed, pos = dec.correct_errors(t(bad), k, field, erased=erased,
                                    entropy=entropy)
    jfixed, jpos = jdec.correct_errors(jnp.asarray(bad), k, _ref(field),
                                       erased=erased)
    assert fixed.dtype == torch.uint32 and fixed.device.type == "cpu"
    assert pos.dtype == np.int64
    return (to_numpy_u32(fixed), pos), (np.asarray(jfixed), jpos)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("kind", ["random", "lfsr", "zeros-prefix"])
def test_berlekamp_massey_matches_reference(field, kind):
    """The numpy BM copy equals the reference's on random sequences,
    genuine short-LFSR sequences and sequences with leading zeros."""
    rng = np.random.default_rng(hash((field.p, kind)) & 0xFFFF)
    p = field.p
    for trial in range(8):
        w = int(rng.integers(4, 160))
        if kind == "random":
            s = rng.integers(0, p, size=w, dtype=np.uint64)
        elif kind == "lfsr":
            tt = int(rng.integers(1, max(2, w // 3)))
            lam = rng.integers(0, p, size=tt, dtype=np.uint64)
            s = np.zeros(w, dtype=np.uint64)
            s[:tt] = rng.integers(0, p, size=tt, dtype=np.uint64)
            for r in range(tt, w):
                s[r] = sum(int(lam[i]) * int(s[r - 1 - i])
                           for i in range(tt)) % p
        else:
            s = rng.integers(0, p, size=w, dtype=np.uint64)
            s[: int(rng.integers(0, w // 2 + 1))] = 0
        got = dec._berlekamp_massey(s, p)
        np.testing.assert_array_equal(got, jdec._berlekamp_massey(s, p),
                                      err_msg=f"{kind} trial {trial}")
        assert dec._lfsr_holds(got, s, np.uint64(p))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("erasures", [0, 20], ids=["plain", "erased"])
def test_syndrome_combos_match_reference(field, erasures):
    """The combos drawn from one seed, the syndromes of a corrupted
    codeword and their two lane combinations (a ragged lane count), bit
    for bit; with erasures the locator's evaluations ride the transform."""
    n, k, lanes = 128, 64, 37
    bad = encode(field, k, n, lanes)
    bad[[3, 90]] = rand_field(field, (2, lanes))
    rng_p, rng_r = np.random.default_rng(11), np.random.default_rng(11)
    c1 = dec._rand_combo(field, lanes, rng_p, "cpu")
    c2 = dec._rand_combo(field, lanes, rng_p, "cpu")
    r1 = jdec._rand_combo(_ref(field), lanes, rng_r)
    r2 = jdec._rand_combo(_ref(field), lanes, rng_r)
    np.testing.assert_array_equal(to_numpy_u32(c1), np.asarray(r1))
    np.testing.assert_array_equal(to_numpy_u32(c2), np.asarray(r2))
    base, pre, jpre = k, None, None
    if erasures:
        erased = np.sort(RNG.choice(n, size=erasures, replace=False))
        l_eval, _ = dec.locator_host(erased, n, field)
        prep = np.asarray(dec.prepare_consts(field, l_eval))
        pre, jpre, base = t(prep), jnp.asarray(prep), k + erasures
    s1, s2 = dec._syndrome_combos(t(bad), pre, c1, c2, field, base)
    j1, j2 = jdec._syndrome_combos(jnp.asarray(bad), jpre, r1, r2,
                                   _ref(field), base)
    assert s1.shape == (n - base,)
    np.testing.assert_array_equal(to_numpy_u32(s1), np.asarray(j1))
    np.testing.assert_array_equal(to_numpy_u32(s2), np.asarray(j2))
    assert to_numpy_u32(s1).any()


def test_lane_combo_row_blocks(monkeypatch):
    """Row blocks of _lane_combo (small here) give the one-block result and
    the reference's log-depth modular sum."""
    x = rand_field(GF32, (50, 300))
    c = rand_field(GF32, (300,))
    whole = dec._lane_combo(GF32, t(x), t(c))
    monkeypatch.setattr(dec, "_COMBO_BLOCK", 900)
    blocked = dec._lane_combo(GF32, t(x), t(c))
    assert torch.equal(whole, blocked)
    np.testing.assert_array_equal(to_numpy_u32(whole), np.asarray(
        jdec._lane_combo(_ref(GF32), jnp.asarray(x), jnp.asarray(c))))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("nerr", [1, 7, 31])
def test_locate_and_correct_unknown_errors(field, nerr):
    """t <= (n-k)/2 corrupted rows (+1 mod p), no erasure information:
    both packages locate exactly those rows and return the codeword."""
    n, k, lanes = 256, 128, 5
    cw = encode(field, k, n, lanes)
    rng = np.random.default_rng(100 + nerr)
    pos = np.sort(rng.choice(n, size=nerr, replace=False))
    bad = cw.copy()
    bad[pos] = (bad[pos].astype(np.uint64) + 1) % field.p
    located = dec.locate_errors(t(bad), k, field, entropy=5)
    np.testing.assert_array_equal(located, pos)
    np.testing.assert_array_equal(
        located, jdec.locate_errors(jnp.asarray(bad), k, _ref(field),
                                    entropy=5))
    (fixed, fpos), (jfixed, jpos) = both_correct(bad, k, field)
    np.testing.assert_array_equal(fixed, cw)
    np.testing.assert_array_equal(fixed, jfixed)
    np.testing.assert_array_equal(fpos, pos)
    np.testing.assert_array_equal(fpos, jpos)


def test_locate_errors_clean_codeword():
    n, k = 128, 64
    cw = encode(GF32, k, n, 3)
    located = dec.locate_errors(t(cw), k, GF32, entropy=1)
    assert located is not None and located.size == 0
    assert located.dtype == np.int64
    (fixed, pos), (jfixed, _) = both_correct(cw, k, GF32)
    assert pos.size == 0
    np.testing.assert_array_equal(fixed, cw)
    np.testing.assert_array_equal(fixed, jfixed)


def test_correct_errors_beyond_capacity_fails_loudly():
    """More than (n-k)/2 corrupted rows raise in both packages."""
    n, k = 128, 64
    bad = encode(GF32, k, n, 3)
    rng = np.random.default_rng(9)
    pos = np.sort(rng.choice(n, size=(n - k) // 2 + 5, replace=False))
    bad[pos] = (bad[pos].astype(np.uint64) + 3) % GF32.p
    assert dec.locate_errors(t(bad), k, GF32, entropy=3) is None
    with pytest.raises(ValueError, match="not locatable"):
        dec.correct_errors(t(bad), k, GF32, entropy=3)
    with pytest.raises(ValueError):
        jdec.correct_errors(jnp.asarray(bad), k, _ref(GF32))


def test_correct_errors_at_exact_capacity():
    """t == (n-k)/2, rows replaced by random values: the located rows are
    exactly those that differ."""
    n, k, lanes = 128, 64, 4
    nerr = (n - k) // 2
    cw = encode(GF32, k, n, lanes)
    rng = np.random.default_rng(77)
    pos = np.sort(rng.choice(n, size=nerr, replace=False))
    bad = cw.copy()
    bad[pos] = rand_field(GF32, (nerr, lanes), rng)
    diff = np.nonzero((bad != cw).any(axis=1))[0]
    (fixed, fpos), (jfixed, jpos) = both_correct(bad, k, GF32)
    np.testing.assert_array_equal(fpos, diff)
    np.testing.assert_array_equal(fpos, jpos)
    np.testing.assert_array_equal(fixed, cw)
    np.testing.assert_array_equal(fixed, jfixed)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_errors_and_erasures_combined(field):
    """e + 2t = n - k: 100 known-lost rows holding garbage and 14 silent
    errors, recovered together; the erasures also travel as a tensor."""
    n, k, lanes = 256, 128, 4
    e, nerr = 100, 14
    cw = encode(field, k, n, lanes)
    rng = np.random.default_rng(5)
    picks = rng.choice(n, size=e + nerr, replace=False)
    erased, errs = np.sort(picks[:e]), np.sort(picks[e:])
    bad = cw.copy()
    bad[erased] = rand_field(field, (e, lanes), rng)
    bad[errs] = (bad[errs].astype(np.uint64) + 1) % field.p
    (fixed, pos), (jfixed, jpos) = both_correct(bad, k, field, erased=erased)
    np.testing.assert_array_equal(pos, errs)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(fixed, cw)
    np.testing.assert_array_equal(fixed, jfixed)
    fixed2, pos2 = dec.correct_errors(t(bad), k, field,
                                      erased=torch.from_numpy(erased))
    np.testing.assert_array_equal(to_numpy_u32(fixed2), cw)
    np.testing.assert_array_equal(pos2, errs)


def test_errors_and_erasures_beyond_capacity():
    n, k = 128, 64
    e, nerr = 50, 10                    # 50 + 20 > 64
    bad = encode(GF32, k, n, 3)
    rng = np.random.default_rng(6)
    picks = rng.choice(n, size=e + nerr, replace=False)
    erased, errs = np.sort(picks[:e]), np.sort(picks[e:])
    bad[erased] = 0
    bad[errs] = (bad[errs].astype(np.uint64) + 9) % GF32.p
    with pytest.raises(ValueError):
        dec.correct_errors(t(bad), k, GF32, erased=erased, entropy=2)
    with pytest.raises(ValueError):
        jdec.correct_errors(jnp.asarray(bad), k, _ref(GF32), erased=erased)
    assert dec.locate_errors(t(bad), k, GF32, erased=np.arange(n - k),
                             entropy=2) is None      # k + e >= n


def test_locate_errors_survives_fixed_combo_annihilation():
    """Corruption whose lane combination vanishes under both of the
    reference's former fixed combo seeds (0xE0C, 0x5EED) is still found
    with entropy-drawn combos."""
    n, k, lanes = 128, 64, 8
    p = GF32.p
    cw = encode(GF32, k, n, lanes)
    old1 = np.random.default_rng(0xE0C).integers(1, p, size=lanes,
                                                 dtype=np.uint64)
    old2 = np.random.default_rng(0x5EED).integers(1, p, size=lanes,
                                                  dtype=np.uint64)
    a1, a2, a3 = (int(old1[i]) for i in range(3))
    b1, b2, b3 = (int(old2[i]) for i in range(3))
    inv_det = pow((a1 * b2 - a2 * b1) % p, p - 2, p)
    e0 = (-(a3 * b2 - a2 * b3)) * inv_det % p
    e1 = (-(a1 * b3 - a3 * b1)) * inv_det % p
    row = 37
    bad = cw.copy()
    for lane, err in ((0, e0), (1, e1), (2, 1)):
        bad[row, lane] = (int(bad[row, lane]) + err) % p
    err_cw = (bad.astype(np.int64) - cw.astype(np.int64)) % p
    for combo in (old1, old2):
        syn = (err_cw.astype(np.uint64) * combo[None, :] % p).sum(axis=1) % p
        assert not syn.any(), "construction failed to annihilate"
    # under the old seed itself the port's combos see nothing either
    s1, s2 = dec._syndrome_combos(
        t(bad), None, *(t(dec.prepare_consts(GF32, c.astype(np.uint32)))
                        for c in (old1, old2)), GF32, k)
    assert not to_numpy_u32(s1).any() and not to_numpy_u32(s2).any()
    np.testing.assert_array_equal(dec.locate_errors(t(bad), k, GF32), [row])
    (fixed, pos), (jfixed, jpos) = both_correct(bad, k, GF32)
    np.testing.assert_array_equal(fixed, cw)
    np.testing.assert_array_equal(pos, [row])
    np.testing.assert_array_equal(jpos, [row])


def test_locate_errors_reproducible_entropy():
    """entropy= pins the combo draw: the same positions twice, in both
    packages."""
    n, k = 128, 64
    bad = encode(GF32, k, n, 4)
    bad[5] = (bad[5].astype(np.uint64) + 1) % GF32.p
    a = dec.locate_errors(t(bad), k, GF32, entropy=42)
    b = dec.locate_errors(t(bad), k, GF32, entropy=42)
    np.testing.assert_array_equal(a, [5])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        a, jdec.locate_errors(jnp.asarray(bad), k, _ref(GF32), entropy=42))


def test_correct_errors_raises_on_combo_fluke(monkeypatch):
    """Nothing located but the codeword inconsistent (both combos
    annihilated): ValueError, not a silent pass."""
    n, k = 64, 32
    bad = encode(GF32, k, n, 2)
    bad[3, 0] = (int(bad[3, 0]) + 1) % GF32.p
    monkeypatch.setattr(dec, "locate_errors",
                        lambda *a, **kw: np.empty(0, np.int64))
    with pytest.raises(ValueError, match="no corrupt rows located"):
        dec.correct_errors(t(bad), k, GF32)


def _blocks(field, n, k, block_bytes, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (k, block_bytes), dtype=np.uint8)
    parity = np.asarray(jrs.encode_blocks_jit(jnp.asarray(raw), _ref(field),
                                              n))
    return raw, parity


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("missing", [0, 24], ids=["all", "erased"])
def test_decode_blocks_check_corrects_lying_survivors(field, missing):
    """decode_blocks(check=True) over survivors of which some data and
    parity blocks were silently changed: the port returns the raw data,
    as the reference does; without check the corruption gets through."""
    n, k, block_bytes = 128, 64, 256
    raw, parity = _blocks(field, n, k, block_bytes, 0xB1 + missing)
    dpos = set(rs.data_positions(n, k).tolist())
    ppos = {int(q): i for i, q in enumerate(rs.parity_positions(n, k))}
    rng = np.random.default_rng(missing)
    keep = np.sort(rng.choice(n, size=n - missing, replace=False))
    surv = {int(q): bytearray(raw[q // 2] if q in dpos else parity[ppos[q]])
            for q in keep}
    lied = rng.choice(keep, size=6, replace=False)
    for q in lied:
        surv[int(q)][8] ^= 0x01                # low bit: stays canonical
    surv = {q: bytes(b) for q, b in surv.items()}
    assert any(int(q) in dpos for q in lied)
    got = dec.decode_blocks(surv, n, k, field, block_bytes=block_bytes,
                            check=True, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), raw)
    np.testing.assert_array_equal(got.numpy(), jdec.decode_blocks(
        surv, n, k, _ref(field), block_bytes=block_bytes, check=True))
    unchecked = dec.decode_blocks(surv, n, k, field, block_bytes=block_bytes,
                                  device="cpu")
    assert not np.array_equal(unchecked.numpy(), raw)


def test_decode_blocks_check_on_consistent_survivors():
    """check=True on honest survivors changes nothing (one more transform,
    no correction), with and without erasures."""
    n, k, block_bytes = 64, 32, 256
    raw, parity = _blocks(GF32, n, k, block_bytes, 3)
    full = {2 * i: raw[i].tobytes() for i in range(k)}
    full.update({2 * i + 1: parity[i].tobytes() for i in range(k)})
    some = {q: b for q, b in full.items() if q % 3}
    for surv in (full, some):
        got = dec.decode_blocks(surv, n, k, GF32, block_bytes=block_bytes,
                                check=True, device="cpu")
        np.testing.assert_array_equal(got.numpy(), raw)
