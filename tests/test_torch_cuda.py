"""The port's CUDA kernels on the card: each of K1-K15 against its plain
version, and the entry points on the card against the
same calls on the CPU. Every test here needs a CUDA device and skips without one.

The file imports neither JAX nor the JAX package, so it also runs on a
machine with the card and no JAX; there the JAX-pinning conftest is left
out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fastecc_tpu_torch import decode, fields, gf, ntt, rs, testing
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
from fastecc_tpu_torch.kernels import microbench as mb
from fastecc_tpu_torch.kernels import ntt_mfa as m

torch.set_num_threads(1)

RNG = np.random.default_rng(0xC0DB)
FIELDS = [fields.GF32, fields.GF16]

pytestmark = pytest.mark.cuda


def rand_field(field, shape, rng=RNG):
    return rng.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_kernels_match_plain_on_card(field, cuda_device):
    """K1-K4 vs their plain versions on the card, small orders, ragged
    lane counts."""
    for k, lanes in ((4, 3), (1 << 7, 13), (1 << 10, 40)):
        g = field.root_of_order(2 * k)
        c1 = m._pair_split(k)
        x = from_numpy_u32(rand_field(field, (c1, k // c1, lanes)),
                           cuda_device)
        y = from_numpy_u32(rand_field(field, (k // c1, c1, lanes)),
                           cuda_device)
        assert torch.equal(m.col_pass(x, field, inverse=True),
                           m.col_pass_plain(x, field, inverse=True))
        assert torch.equal(m.col_pass_pre(x, field, g),
                           m.col_pass_plain(x, field, pre_seed=g))
        assert torch.equal(m.seam_pass(y, field, g),
                           m.seam_pass_plain(y, field, g))
        assert torch.equal(m.row_pass(x, field), m.row_pass_plain(x, field))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_row_kernel_every_length_on_card(field, inverse, cuda_device):
    """K3 (row.cu, one instantiation per length) vs its plain version at
    every A = 2 .. 1024, over 1, 3, 13 and 40 lanes (the 4-byte copy path
    where L % 4 != 0, ragged lane tiles), and on a contiguous view 4 bytes
    past a 16-byte boundary, which must take the 4-byte copies too."""
    for la in range(1, 11):
        a = 1 << la
        for lanes in (1, 3, 13, 40):
            y = from_numpy_u32(rand_field(field, (a, 3, lanes)), cuda_device)
            assert torch.equal(m.row_pass(y, field, inverse),
                               m.row_pass_plain(y, field, inverse)), (a, lanes)
        big = from_numpy_u32(rand_field(field, a * 2 * 8 + 1), cuda_device)
        y = big[1:].reshape(a, 2, 8)
        assert y.data_ptr() % 16 == 4
        assert torch.equal(m.row_pass(y, field, inverse),
                           m.row_pass_plain(y, field, inverse)), (a, "offset")


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_col_kernel_every_length_on_card(field, inverse, cuda_device):
    """K1 (col.cu, one instantiation per length and direction; the inverse
    scaled and not) vs its plain version at every A = 2 .. 1024 on
    [A, 4, L] (two seed columns, two t0 rows), over 1, 3, 13 and 40
    lanes, and on a contiguous view 4 bytes past a 16-byte boundary."""
    for la in range(1, 11):
        a = 1 << la
        views = [from_numpy_u32(rand_field(field, (a, 4, lanes)), cuda_device)
                 for lanes in (1, 3, 13, 40)]
        big = from_numpy_u32(rand_field(field, a * 4 * 8 + 1), cuda_device)
        views.append(big[1:].reshape(a, 4, 8))
        assert views[-1].data_ptr() % 16 == 4
        for x in views:
            for scale in (True, False) if inverse else (True,):
                assert torch.equal(
                    m.col_pass(x, field, inverse, scale),
                    m.col_pass_plain(x, field, inverse, scale)), (
                        a, x.shape[-1], x.data_ptr() % 16, scale)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_seam_kernel_every_length_on_card(field, cuda_device):
    """K2 (col.cu, the register hand-off between its two transforms) vs
    its plain version at every A = R1 = 2 .. 1024 on [A, 4, L], over 1,
    3, 13 and 40 lanes, and on a view 4 bytes past a 16-byte boundary."""
    for la in range(1, 11):
        a = 1 << la
        g = field.root_of_order(2 * a * 4)
        views = [from_numpy_u32(rand_field(field, (a, 4, lanes)), cuda_device)
                 for lanes in (1, 3, 13, 40)]
        big = from_numpy_u32(rand_field(field, a * 4 * 8 + 1), cuda_device)
        views.append(big[1:].reshape(a, 4, 8))
        assert views[-1].data_ptr() % 16 == 4
        for y in views:
            assert torch.equal(m.seam_pass(y, field, g),
                               m.seam_pass_plain(y, field, g)), (
                                   a, y.shape[-1], y.data_ptr() % 16)


def rand_table(field, n, rng):
    """A prepared [n] table; GF16 ones hold 0x10000 at every 3rd entry."""
    vals = rand_field(field, n, rng)
    if not field.use_mont:
        vals[::3] = 0x10000
    return vals


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_seam_vec_kernel_every_length_on_card(field, cuda_device):
    """K6 (col.cu, K2's kernel with the middle row from the table) vs its
    plain version at every A = R1 = 2 .. 1024 on [A, 4, L], over 1, 3, 13
    and 40 lanes, and on a view 4 bytes past a 16-byte boundary; GF16
    tables hold 0x10000."""
    rng = np.random.default_rng(0x5EA6 + field.use_mont)
    for la in range(1, 11):
        a = 1 << la
        v = from_numpy_u32(rand_table(field, a * 4, rng), cuda_device)
        views = [from_numpy_u32(rand_field(field, (a, 4, lanes), rng),
                                cuda_device) for lanes in (1, 3, 13, 40)]
        big = from_numpy_u32(rand_field(field, a * 4 * 8 + 1, rng),
                             cuda_device)
        views.append(big[1:].reshape(a, 4, 8))
        assert views[-1].data_ptr() % 16 == 4
        for y in views:
            assert torch.equal(m.seam_pass_vec(y, field, v),
                               m.seam_pass_plain(y, field, pre_vec2=v)), (
                                   a, y.shape[-1], y.data_ptr() % 16)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_col_pre_vec_kernels_every_length_on_card(field, inverse,
                                                  cuda_device):
    """K4 and K5 (col.cu, K1's kernel with the rank-1 row or the table's
    column at step 1's loads; one instantiation per length and direction)
    vs their plain versions at every A = 2 .. 1024 on [A, 4, L], over 13
    and 40 lanes and, at A >= 512, 1088 (the last lane tile), the inverse
    scaled and not; K4's g of order 4A and K5's random tables put
    0x10000 into GF16's factors."""
    rng = np.random.default_rng(0xC45 + 2 * field.use_mont + inverse)
    for la in range(1, 11):
        a = 1 << la
        g = field.root_of_order(4 * a)
        v = from_numpy_u32(rand_table(field, a * 4, rng), cuda_device)
        for lanes in (13, 40) + ((1088,) if a >= 512 else ()):
            x = from_numpy_u32(rand_field(field, (a, 4, lanes), rng),
                               cuda_device)
            for scale in (True, False) if inverse else (True,):
                assert torch.equal(
                    m.col_pass_pre(x, field, g, inverse, scale),
                    m.col_pass_plain(x, field, inverse, scale,
                                     pre_seed=g)), (a, lanes, scale)
                assert torch.equal(
                    m.col_pass_vec(x, field, v, inverse, scale),
                    m.col_pass_plain(x, field, inverse, scale,
                                     pre_vec=v)), (a, lanes, scale)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_row_post_sel_kernel_every_length_on_card(field, inverse,
                                                  cuda_device):
    """K7-sel (row.cu, K3's kernel with the select in its store) vs its
    plain version at every A = 2 .. 1024 on [A, 3, L], over 1, 3, 13 and
    40 lanes and on a view 4 bytes past a 16-byte boundary: masks all 0,
    about half set (with 1, 0x100 and 0x80000000: any value but 0
    selects) and all set, the original a tensor of its own and the
    pass's input; GF16 tables hold 0x10000."""
    rng = np.random.default_rng(0x5E1 + 2 * field.use_mont + inverse)
    for la in range(1, 11):
        a = 1 << la
        v = from_numpy_u32(rand_table(field, a * 3, rng), cuda_device)
        sel = rng.choice(np.array([1, 0x100, 0x80000000], np.uint32), a * 3)
        half = np.where(rng.random(a * 3) < 0.5, sel, 0).astype(np.uint32)
        masks = [from_numpy_u32(mk, cuda_device) for mk in (
            np.zeros(a * 3, np.uint32), half, sel)]
        views = [from_numpy_u32(rand_field(field, (a, 3, lanes), rng),
                                cuda_device) for lanes in (1, 3, 13, 40)]
        big = from_numpy_u32(rand_field(field, a * 3 * 8 + 1, rng),
                             cuda_device)
        views.append(big[1:].reshape(a, 3, 8))
        assert views[-1].data_ptr() % 16 == 4
        for y in views:
            orig = from_numpy_u32(rand_field(field, tuple(y.shape), rng),
                                  cuda_device)
            for mk in masks:
                for o in (orig, y):
                    assert torch.equal(
                        m.row_pass_post(y, field, v, mk, o, inverse),
                        m.row_pass_plain(y, field, inverse, v, mk, o)), (
                            a, y.shape[-1], y.data_ptr() % 16, o is y)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_row_post_kernel_every_length_on_card(field, inverse, cuda_device):
    """K7 (row.cu, K3's kernel with the table multiply in its store) vs its
    plain version at every A = 2 .. 1024 on [A, 3, L], over 1, 3, 13 and
    40 lanes and on a view 4 bytes past a 16-byte boundary; GF16 tables
    hold 0x10000."""
    rng = np.random.default_rng(0x7057 + 2 * field.use_mont + inverse)
    for la in range(1, 11):
        a = 1 << la
        v = from_numpy_u32(rand_table(field, a * 3, rng), cuda_device)
        views = [from_numpy_u32(rand_field(field, (a, 3, lanes), rng),
                                cuda_device) for lanes in (1, 3, 13, 40)]
        big = from_numpy_u32(rand_field(field, a * 3 * 8 + 1, rng),
                             cuda_device)
        views.append(big[1:].reshape(a, 3, 8))
        assert views[-1].data_ptr() % 16 == 4
        for y in views:
            assert torch.equal(m.row_pass_post(y, field, v, inverse=inverse),
                               m.row_pass_plain(y, field, inverse, v)), (
                                   a, y.shape[-1], y.data_ptr() % 16)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_decode_kernels_match_plain_on_card(field, cuda_device):
    """K5, K6, K7 and K7-sel vs their plain versions on the card, small
    orders, ragged lane counts; GF16 tables hold 0x10000."""
    for k, lanes in ((4, 3), (1 << 7, 13), (1 << 10, 40)):
        c1 = m._pair_split(k)
        x = from_numpy_u32(rand_field(field, (c1, k // c1, lanes)),
                           cuda_device)
        y = from_numpy_u32(rand_field(field, (k // c1, c1, lanes)),
                           cuda_device)
        vals = rand_field(field, k)
        if not field.use_mont:
            vals[::3] = 0x10000
        v = from_numpy_u32(vals, cuda_device)
        mask = from_numpy_u32((RNG.random(k) < 0.5).astype(np.uint32),
                              cuda_device)
        for inv in (False, True):
            assert torch.equal(m.col_pass_vec(x, field, v, inverse=inv),
                               m.col_pass_plain(x, field, inverse=inv,
                                                pre_vec=v))
        assert torch.equal(m.seam_pass_vec(y, field, v),
                           m.seam_pass_plain(y, field, pre_vec2=v))
        assert torch.equal(m.row_pass_post(x, field, v),
                           m.row_pass_plain(x, field, post_vec=v))
        assert torch.equal(m.row_pass_post(x, field, v, mask, y.reshape(
            x.shape)), m.row_pass_plain(x, field, post_vec=v, sel_mask=mask,
                                        sel_orig=y.reshape(x.shape)))


def equal_plain_by_lanes(got, fn, x, *lanes_too, chunk=128):
    """Whether ``got`` == ``fn`` (a plain pass) on every ``chunk``-lane
    slice of ``x`` and of each tensor in ``lanes_too`` (lanes are the last
    axis and independent): the plain versions compute in int64 and at the
    cells' full width would hold tens of GB at once."""
    return all(torch.equal(got[..., l0:l0 + chunk].contiguous(), fn(*(
        t[..., l0:l0 + chunk].contiguous() for t in (x,) + lanes_too)))
        for l0 in range(0, x.shape[-1], chunk))


def solinas_edge_words():
    """``microbench.solinas_edge_inputs``' x and z as numpy: pair i's
    a-side at x[i, 0], its b-side at z[i, 0]; every word below p."""
    return tuple(to_numpy_u32(t) for t in mb.solinas_edge_inputs("cpu"))


def solinas_edge_data(n, lanes, rng, device):
    """GF32 [n, lanes] data below p holding the edge words: pair i's
    a-side across the first half of row i's lanes, and all of x in rows
    512 .. 1023 of the last 128 lanes."""
    ex, _ = solinas_edge_words()
    ts, tl = ex.shape
    x = rand_field(fields.GF32, (n, lanes), rng)
    x[:ts, :lanes // 2] = ex[:, :1]
    x[ts:2 * ts, -tl:] = ex
    return from_numpy_u32(x, device)


def solinas_edge_table(n, rng, device):
    """A prepared GF32 [n] table whose entry i is pair i's b-side, so a
    pass that multiplies row m by entry m of data from
    :func:`solinas_edge_data` multiplies the edge pairs themselves."""
    _, ez = solinas_edge_words()
    v = rand_field(fields.GF32, n, rng)
    v[:len(ez)] = ez[:, 0]
    return from_numpy_u32(v, device)


def test_encode_pair_at_cell_shape_on_card(cuda_device):
    """K1 -> K2 -> K3 at the GF32 encode cell's [512, 1024, 1024] (k =
    2^19 over 1024 lanes, every pass multiplying through the Solinas REDC),
    on data carrying the Solinas edge words: each pass, fed the kernel
    chain's previous output, == its plain version on every lane."""
    field, k, lanes = fields.GF32, 1 << 19, 1024
    rng = np.random.default_rng(0xE9C0)
    g = field.root_of_order(2 * k)
    c1 = m._pair_split(k)
    x3 = solinas_edge_data(k, lanes, rng, cuda_device).reshape(
        c1, k // c1, lanes)
    assert tuple(x3.shape) == (512, 1024, 1024)
    col1 = m.col_pass(x3, field, inverse=True, scale=True)
    assert equal_plain_by_lanes(
        col1, lambda x: m.col_pass_plain(x, field, True, True), x3)
    del x3
    col2 = m.seam_pass(col1, field, g)
    assert equal_plain_by_lanes(
        col2, lambda y: m.seam_pass_plain(y, field, g), col1)
    del col1
    out = m.row_pass(col2, field)
    assert equal_plain_by_lanes(
        out, lambda y: m.row_pass_plain(y, field), col2)


def test_decode_pair_at_cell_shape_on_card(cuda_device):
    """K5 -> K6 -> K7-sel at the GF32 repair cell's [1024, 1024, 512] (n =
    2^20 over 512 lanes): the three tables hold the Solinas edge words'
    b-sides at the rows whose data holds their a-sides, and about half
    the rows are erased, the edge rows among them. Each pass, fed the
    kernel chain's previous output, == its plain version on every lane."""
    field, n, lanes = fields.GF32, 1 << 20, 512
    rng = np.random.default_rng(0xDEC0)
    lp, dx, ip = (solinas_edge_table(n, rng, cuda_device) for _ in range(3))
    mask = (rng.random(n) < 0.5).astype(np.uint32)
    mask[:512] = 1
    mask = from_numpy_u32(mask, cuda_device)
    c1 = m._pair_split(n)
    x3 = solinas_edge_data(n, lanes, rng, cuda_device).reshape(
        c1, n // c1, lanes)
    assert tuple(x3.shape) == (1024, 1024, 512)
    col1 = m.col_pass_vec(x3, field, lp, inverse=True, scale=True)
    assert equal_plain_by_lanes(
        col1, lambda x: m.col_pass_plain(x, field, True, True, pre_vec=lp),
        x3)
    del x3
    col2 = m.seam_pass_vec(col1, field, dx)
    assert equal_plain_by_lanes(
        col2, lambda y: m.seam_pass_plain(y, field, pre_vec2=dx), col1)
    del col1
    orig = from_numpy_u32(rand_field(field, tuple(col2.shape), rng),
                          cuda_device)
    out = m.row_pass_post(col2, field, ip, mask, orig)
    assert equal_plain_by_lanes(
        out, lambda y, o: m.row_pass_plain(y, field, False, ip, mask, o),
        col2, orig)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_decode_on_card_matches_cpu(field, cuda_device):
    """decode_prepared (merge on and off), decode and the device tables
    on the card == on the CPU; the decode pair launches K5, K6, K7-sel."""
    n, k, lanes = 1 << 9, 1 << 8, 7
    erased = testing.random_erasures(n, n - k, seed=2)
    cw = rs.encode(rand_field(field, (k, lanes)), field, n, device="cpu")
    tabs_cpu = decode.prepare_decode_tables(erased, n, field, "device",
                                            device="cpu")
    tabs = decode.prepare_decode_tables(erased, n, field, "device")
    for a, b in zip(tabs, tabs_cpu):
        assert torch.equal(a.cpu(), b)
    for merge in (True, False):
        m.reset_launches()
        got = decode.decode_prepared(cw.to(cuda_device), *tabs, field,
                                     merge=merge)
        assert m.LAUNCHES["K5_col_vec"] == 1 and m.LAUNCHES["K6_seam_vec"] == 1
        assert m.LAUNCHES["K7_row_post_sel" if merge else "K7_row_post"] == 1
        assert torch.equal(got.cpu(), decode.decode_prepared(
            cw, *tabs_cpu, field, merge=merge))
    assert torch.equal(decode.decode(cw.to(cuda_device), erased, field).cpu(),
                       cw)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("k,n", [(8, 16), (64, 256), (256, 512)])
def test_entry_points_on_card_match_cpu(field, k, n, cuda_device):
    """encode_parity and ntt_auto on the card (kernels) == on the CPU
    (plain versions), and the launches are counted."""
    data = rand_field(field, (k, 5))
    m.reset_launches()
    got = rs.encode_parity(data, field, n)
    assert got.is_cuda
    assert torch.equal(got.cpu(), rs.encode_parity(data, field, n,
                                                   device="cpu"))
    assert m.LAUNCHES["K1_col"] > 0 and m.LAUNCHES["K3_row"] > 0
    assert m.LAUNCHES["K2_seam" if n == 2 * k else "K4_col_pre"] > 0
    v = rand_field(field, k)
    for kw in ({}, {"inverse": True}, {"pre_seed": 7}, {"pre_vec": v},
               {"post_vec": v, "sel_mask": v % 2, "sel_orig": data}):
        assert torch.equal(ntt.ntt_auto(data, field, **kw).cpu(),
                           ntt.ntt_auto(data, field, device="cpu", **kw))


def test_card_refuses_what_it_does_not_run(cuda_device):
    x = from_numpy_u32(rand_field(fields.GF32, (2, 4)), cuda_device)
    with pytest.raises(ValueError, match="order >= 4"):
        m.ntt_fused(x, fields.GF32)
    # below the kernels' smallest order ntt_auto takes the torch-op route
    assert torch.equal(ntt.ntt_auto(x, fields.GF32).cpu(),
                       ntt.ntt_auto(x.cpu(), fields.GF32))
    words = torch.zeros((4, 16), dtype=torch.uint32, device=cuda_device)
    with pytest.raises(ValueError, match="rate-1/2"):
        rs.encode_blocks_gf16_parts(words, 16)


@pytest.mark.parametrize("k,wu", [(4, 8), (1 << 7, 40), (1 << 10, 64),
                                  (1 << 15, 8)])
def test_wire16_kernels_match_plain_on_card(k, wu, cuda_device):
    """K8, K9 and K10 vs their plain versions on the card, with Wu a
    multiple of 8 but not of the lane tile; K10 also on outputs that are
    mostly 0x10000 (dense escape words)."""
    f = fields.GF16
    g = f.root_of_order(2 * k)
    c1 = m._pair_split(k)
    r1 = k // c1
    pairs = RNG.integers(0, 1 << 32, size=(c1, r1, wu), dtype=np.uint64)
    x = from_numpy_u32(pairs.astype(np.uint32), cuda_device)
    assert torch.equal(m.col_pass_wire16(x, f),
                       m.col_pass_wire16_plain(x, f))
    y = from_numpy_u32(rand_field(f, (2, r1, c1, wu)), cuda_device)
    assert torch.equal(m.seam_pass_wire16(y, f, g),
                       m.seam_pass_wire16_plain(y, f, g))
    want = np.where(RNG.random((2, c1, r1, wu)) < 0.9, np.uint32(0x10000),
                    rand_field(f, (2, c1, r1, wu)))
    pre = np.stack([ntt.ntt_host(h.reshape(c1, -1), f, inverse=True)
                    for h in want]).reshape(want.shape)
    for z in (rand_field(f, (2, c1, r1, wu)), pre):
        z = from_numpy_u32(z, cuda_device)
        for a, b in zip(m.wire16_pass_b2(z[0], z[1], f),
                        m.row_pass_wire16_plain(z[0], z[1], f)):
            assert torch.equal(a, b)


def test_wire16_encode_on_card_matches_cpu(cuda_device):
    """encode_blocks(GF16) on the card runs K8 -> K9 -> K10 and gives the
    CPU's bytes; a shape outside the wire pair's gate takes K1 -> K3."""
    k = 1 << 8
    raw = RNG.integers(0, 256, (k, 4096), dtype=np.uint8)
    m.reset_launches()
    got = rs.encode_blocks(raw, fields.GF16)
    assert [m.LAUNCHES[n] for n in ("K8_col_wire16", "K9_seam_wire16",
                                    "K10_row_wire16")] == [1, 1, 1]
    assert torch.equal(got.cpu(), rs.encode_blocks(raw, fields.GF16,
                                                   device="cpu"))
    odd = raw[:, :100]
    m.reset_launches()
    got = rs.encode_blocks(odd, fields.GF16)
    assert m.LAUNCHES["K2_seam"] == 1 and m.LAUNCHES["K8_col_wire16"] == 0
    assert torch.equal(got.cpu(), rs.encode_blocks(odd, fields.GF16,
                                                   device="cpu"))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_extras_on_card_match_cpu(field, cuda_device):
    """update_parity_multi, verify_codeword, encode_parity_batch and the
    two streams on the card == on the CPU."""
    k, lanes = 1 << 7, 64
    n = 2 * k
    data = rand_field(field, (k, lanes))
    par = rs.encode_parity(data, field, device="cpu")
    new = rand_field(field, (2, lanes))
    idxs = (3, k - 1)
    args = (idxs, data[list(idxs)], new, field)
    assert torch.equal(rs.update_parity_multi(par.cuda(), *args).cpu(),
                       rs.update_parity_multi(par, *args))
    cw = gf.widen(rs.encode(data, field))
    assert bool(rs.verify_codeword(gf.narrow(cw), field, k))
    cw[5, 7] = (cw[5, 7] + 1) % field.p
    assert not bool(rs.verify_codeword(gf.narrow(cw), field, k))
    batch = rand_field(field, (3, k, 8))
    assert torch.equal(rs.encode_parity_batch(batch, field).cpu(),
                       rs.encode_parity_batch(batch, field, device="cpu"))
    np.testing.assert_array_equal(
        rs.encode_parity_stream(data, field, chunk_lanes=16),
        rs.encode_parity_stream(data, field, chunk_lanes=16, device="cpu"))
    cwh = rs.encode(data, field, device="cpu").view(torch.int32).numpy().view(
        np.uint32)
    erased = testing.random_erasures(n, k, seed=4)
    np.testing.assert_array_equal(
        decode.decode_stream(cwh, erased, field, chunk_lanes=16),
        decode.decode_stream(cwh, erased, field, chunk_lanes=16,
                             device="cpu"))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_lanes_kernel_matches_plain_on_card(field, cuda_device):
    """K11 vs its plain version on the card: lane tiles of 32 (k <= 512),
    16 (k = 2^10) and 4 or 2 (k = 2^13: GF16 or GF32), ragged lane
    counts."""
    for k, lanes in ((4, 3), (32, 37), (1 << 10, 1088), (1 << 13, 13)):
        g = field.root_of_order(2 * k)
        x = from_numpy_u32(rand_field(field, (k, lanes)), cuda_device)
        m.reset_launches()
        assert torch.equal(m.ntt_pair_lanes(x, field, g),
                           m.pair_lanes_plain(x, field, g)), k
        assert m.LAUNCHES["K11_pair_lanes"] == 1


def dense_escape_pairs(k, wu, g, device):
    """[k, wu] u32 pairs whose wire pair output is ~90% 0x10000 in each
    half: the pair with the inverse seed (the pair's inverse) applied to
    such outputs. Preimage values of 0x10000, which a u16 word cannot
    hold, become 0 (that lane's output loses its density)."""
    f = fields.GF16
    halves = []
    for _ in range(2):
        want = np.where(RNG.random((k, wu)) < 0.9, np.uint32(0x10000),
                        rand_field(f, (k, wu)))
        pre = gf.widen(m.pair_lanes_plain(from_numpy_u32(want, device), f,
                                          f.inv_host(g)))
        halves.append(torch.where(pre == 0x10000, 0, pre))
    return gf.narrow(halves[0] | (halves[1] << 16))


@pytest.mark.parametrize("k,wu", [(32, 8), (1 << 10, 40), (1 << 13, 1024)])
def test_lanes_wire16_kernel_matches_plain_on_card(k, wu, cuda_device):
    """K12 vs its plain version on the card at lane tiles of 32, 16 and 4
    (at 4, two lane tiles of two halves, four blocks, OR their bits into
    one bitmap word), on random pairs and
    on pairs whose outputs are mostly 0x10000 (saturated bitmap words)."""
    f = fields.GF16
    g = f.root_of_order(2 * k)
    pairs = RNG.integers(0, 1 << 32, size=(k, wu), dtype=np.uint64)
    dense = dense_escape_pairs(k, wu, g, cuda_device)
    for x in (from_numpy_u32(pairs.astype(np.uint32), cuda_device), dense):
        got = m.ntt_pair_lanes_wire16(x, f, g)
        want = m.pair_lanes_wire16_plain(x, f, g)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((gf.widen(got[1]) == 0xFFFF).any())


@pytest.mark.parametrize("la", range(2, 14))
def test_lanes_wire16_kernel_every_length_on_card(la, cuda_device):
    """K12 (one instantiation per length: the one-exchange split below
    2^12, the two-exchange split at 2^12 and 2^13) vs its plain version at
    k = 2^la over Wu = 8, 40 and 1024."""
    f = fields.GF16
    k = 1 << la
    g = f.root_of_order(2 * k)
    rng = np.random.default_rng(0x12 + la)
    for wu in (8, 40, 1024):
        x = from_numpy_u32(rng.integers(0, 1 << 32, size=(k, wu),
                                        dtype=np.uint64).astype(np.uint32),
                           cuda_device)
        got = m.ntt_pair_lanes_wire16(x, f, g)
        want = m.pair_lanes_wire16_plain(x, f, g)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_seam_wire16_kernel_every_length_on_card(cuda_device):
    """K9 (K2's kernel on each half) vs its plain version at every R1 =
    2 .. 1024 on [2, R1, 4, Wu], Wu = 8, 16 and 40."""
    f = fields.GF16
    rng = np.random.default_rng(0x9)
    for la in range(1, 11):
        a = 1 << la
        g = f.root_of_order(8 * a)
        for wu in (8, 16, 40):
            y = from_numpy_u32(rand_field(f, (2, a, 4, wu), rng), cuda_device)
            assert torch.equal(m.seam_pass_wire16(y, f, g),
                               m.seam_pass_wire16_plain(y, f, g)), (a, wu)


def test_col_wire16_kernel_every_length_on_card(cuda_device):
    """K8 (col.cu, K1's GF16 kernel on both halves in one block) vs its plain
    version at every C1 = 2 .. 1024 on [C1, 4, Wu] random 32-bit pairs,
    Wu = 8, 40 and 1024, and on a view 4 bytes past a 16-byte boundary
    (the 4-byte copies)."""
    f = fields.GF16
    rng = np.random.default_rng(0x8)
    for la in range(1, 11):
        a = 1 << la
        views = [from_numpy_u32(rng.integers(
            0, 1 << 32, size=(a, 4, wu), dtype=np.uint64).astype(np.uint32),
            cuda_device) for wu in (8, 40, 1024)]
        big = from_numpy_u32(rng.integers(
            0, 1 << 32, size=a * 4 * 8 + 1, dtype=np.uint64).astype(
                np.uint32), cuda_device)
        views.append(big[1:].reshape(a, 4, 8))
        assert views[-1].data_ptr() % 16 == 4
        for x in views:
            assert torch.equal(m.col_pass_wire16(x, f),
                               m.col_pass_wire16_plain(x, f)), (
                                   a, x.shape[-1], x.data_ptr() % 16)


def test_row_wire16_kernel_every_length_on_card(cuda_device):
    """K10 (row.cu, K3's GF16 schedule on both halves in one block, the
    bitmap from warp ballots) vs its plain version at every A = 2 .. 1024
    on [A, 2, Wu], Wu = 8, 40 and 1032 (a last lane tile of 8), 0x10000 at
    about a tenth of the elements, and on lo and hi views 4 bytes past a
    16-byte boundary (the 4-byte copies)."""
    f = fields.GF16
    rng = np.random.default_rng(0x10)

    def halves(*shape):
        v = rand_field(f, shape, rng)
        v[rng.random(shape) < 0.1] = 0x10000
        return from_numpy_u32(v, cuda_device)
    for la in range(1, 11):
        a = 1 << la
        cases = [halves(2, a, 2, wu) for wu in (8, 40, 1032)]
        cases.append(halves(2 * a * 2 * 8 + 1)[1:].reshape(2, a, 2, 8))
        assert cases[-1][1].data_ptr() % 16 == 4
        for h in cases:
            got = m.wire16_pass_b2(h[0], h[1], f)
            want = m.row_pass_wire16_plain(h[0], h[1], f)
            assert torch.equal(got[0], want[0]) and torch.equal(
                got[1], want[1]), (a, h.shape[-1], h[0].data_ptr() % 16)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_lanes_kernel_every_length_on_card(field, cuda_device):
    """K11 (lanes.cu, one instantiation per length and field) vs its plain
    version at every k = 4 .. 2^13 over 13 and 1088 lanes and on a view 4
    bytes past a 16-byte boundary."""
    rng = np.random.default_rng(0x11 + field.use_mont)
    for la in range(2, 14):
        k = 1 << la
        g = field.root_of_order(2 * k)
        xs = [from_numpy_u32(rand_field(field, (k, n), rng), cuda_device)
              for n in (13, 1088)]
        xs.append(from_numpy_u32(rand_field(field, k * 8 + 1, rng),
                                 cuda_device)[1:].reshape(k, 8))
        assert xs[-1].data_ptr() % 16 == 4
        for x in xs:
            assert torch.equal(m.ntt_pair_lanes(x, field, g),
                               m.pair_lanes_plain(x, field, g)), (
                                   k, x.shape[1], x.data_ptr() % 16)


def test_lanes_dispatch_on_card(cuda_device, monkeypatch):
    """With the flag on, the rate-1/2 encode, the batch, the GF32 wire
    decode and the GF16 wire encode launch K11 / K12 alone and give the
    three-pass route's bits."""
    f32, f16 = fields.GF32, fields.GF16
    data = rand_field(f32, (1 << 10, 96))
    raw = RNG.integers(0, 256, (1 << 8, 4096), dtype=np.uint8)
    par = rs.encode_blocks(raw, f32)

    def run():
        return (rs.encode_parity(data, f32), rs.encode_parity_batch(
            data.reshape(1 << 10, 2, 48).transpose(1, 0, 2).copy(), f32),
            decode.decode_wire_parts(par.view(torch.uint32), 1 << 9, 1 << 8,
                                     f32), rs.encode_blocks(raw, f16))

    off = run()
    monkeypatch.setattr(m, "LANES_PAIR_ENABLED", True)
    m.reset_launches()
    on = run()
    assert {k: v for k, v in m.LAUNCHES.items() if v} == {
        "K11_pair_lanes": 3, "K12_pair_lanes_wire16": 1}
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_copy_kernel_matches_plain_on_card(cuda_device):
    """K13 == clone at ragged sizes and on a pointer that is not 16-byte
    aligned (the scalar path), and over 64 MiB (thousands of blocks on
    either path)."""
    words = torch.from_numpy(RNG.integers(0, 1 << 32, 4099, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    x = words.to(cuda_device).view(torch.uint32)
    big = torch.arange((1 << 24) + 5, dtype=torch.int32,
                       device=cuda_device).view(torch.uint32)
    mb.reset_launches()
    for n in (1, 3, 4, 1027, 4099):
        assert torch.equal(mb.copy(x[:n]), x[:n].clone())
    assert torch.equal(mb.copy(x[1:]), x[1:].clone())
    assert torch.equal(mb.copy(big), big)
    assert torch.equal(mb.copy(big[1:]), big[1:])
    assert mb.LAUNCHES["K13_copy"] == 8


def test_copy_kernel_sizes_on_card(cuda_device):
    """K13 == clone at 1 word, at 4n + 1 .. 4n + 3 words (the vector path,
    one vector a thread, and block 0's tail), around multiples of 1024
    words (a block's span: one vector of 4 words for each of 256 threads)
    and, from a pointer 4 bytes past a 16-byte boundary, around multiples
    of 256 words (likewise for the scalar path)."""
    big = torch.from_numpy(RNG.integers(0, 1 << 32, 3 * 4096 + 8,
                                        dtype=np.uint64).astype(np.uint32)
                           .view(np.int32)).to(cuda_device).view(torch.uint32)
    sizes = [1, 2, 4, 1023, 1024, 1025, 1026, 1027, 2047, 2049, 4095, 4097,
             3 * 4096 - 1, 3 * 4096 + 1]
    for n in sizes:
        assert torch.equal(mb.copy(big[:n]), big[:n].clone()), n
    for n in (255, 256, 257, 1023, 1025, 2049):
        assert torch.equal(mb.copy(big[1:n + 1]), big[1:n + 1].clone()), n


@pytest.mark.parametrize("variant", list(mb._VARIANTS))
def test_chain_kernel_matches_plain_on_card(variant, cuda_device):
    """K14 == its plain version for every variant at depth 3 and at the
    variant's default depth, on four 512-row tiles."""
    x, z = mb.chain_inputs(4 * mb._TS, cuda_device)
    deep = (mb._COMPOSITE_DEPTH if variant in mb._COMPOSITE
            else mb._DEFAULT_DEPTH)
    for depth in (0, 3, deep):
        assert torch.equal(mb.chain(x, z, variant, depth),
                           mb.chain_plain(x, z, variant, depth)), depth


@pytest.mark.parametrize("key", list(mb._FUSED_CONFIGS))
def test_fused_chain_kernel_matches_plain_on_card(key, cuda_device):
    """K15 == its plain version on the three fused configs, one and two
    row tiles, depth 2, and at c = 2 with a ragged lane count."""
    cfg = mb._FUSED_CONFIGS[key]
    field = fields.FIELDS[cfg["field_name"]]
    for rows_tiles in (1, 2):
        x = mb.fused_inputs(field, cfg["c"], rows_tiles, cuda_device)
        assert torch.equal(mb.fused_chain(x, field, 2),
                           mb.fused_chain_plain(x, field, 2)), rows_tiles
    y = from_numpy_u32(rand_field(field, (2, 37)), cuda_device)
    assert torch.equal(mb.fused_chain(y, field, 3),
                       mb.fused_chain_plain(y, field, 3))


@pytest.mark.parametrize("variant", ["solinas", "solinas-bcast",
                                     "solinas-masksel"])
def test_solinas_chain_on_edge_pairs_on_card(variant, cuda_device):
    """K14's Solinas family == its plain version on the edge operands
    (microbench.solinas_edge_pairs: edge words, zero low words, both sides
    of every conditional step of the REDC) at depths 1, 3 and 128."""
    x, z = mb.solinas_edge_inputs(cuda_device)
    for depth in (1, 3, mb._DEFAULT_DEPTH):
        assert torch.equal(mb.chain(x, z, variant, depth),
                           mb.chain_plain(x, z, variant, depth)), depth


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_fused_chain_every_length_on_card(field, cuda_device):
    """K15 == its plain version at every c = 2 .. 2048, depths 0-3, over
    13 and 40 lanes (the last block zero-filled past L)."""
    rng = np.random.default_rng(0xF15 + field.use_mont)
    for la in range(1, 12):
        for lanes in (13, 40):
            y = from_numpy_u32(rand_field(field, (1 << la, lanes), rng),
                               cuda_device)
            for depth in range(4):
                assert torch.equal(mb.fused_chain(y, field, depth),
                                   mb.fused_chain_plain(y, field, depth)), (
                    la, lanes, depth)


def test_sharded_encode_on_card_matches_single_card(cuda_device, tmp_path):
    """Two ranks share the card over Gloo (NCCL refuses two ranks of one
    communicator on one GPU): the sharded encode of [2^12, 64] launches
    K1 and K3 in each rank, runs 4 exchanges and gives every rank the
    single-card encode's rows."""
    from fastecc_tpu_torch.parallel import _worker
    from fastecc_tpu_torch.interop import to_numpy_u32
    k, lanes = 1 << 12, 64
    data = _worker.seeded_u32(fields.GF32.p, (k, lanes), 7, cuda_device)
    want = tmp_path / "want.npy"
    np.save(want, to_numpy_u32(rs.encode_parity(data, fields.GF32)))
    reps = _worker.launch({"mesh": (2, 1), "device": "cuda", "cases": [
        {"name": "enc", "op": "encode", "field": "GF32",
         "input": {"seeded": [k, lanes], "seed": 7}, "want": str(want)}]},
        2, timeout=300)
    for rep in reps:
        case = rep["cases"]["enc"]
        assert rep["backend"] == "gloo" and rep["device"] == "cuda:0"
        assert case["bit_exact"] is True
        assert case["collectives"]["all_to_all"] == 4
        assert case["launches"]["K1_col"] > 0 and case["launches"]["K3_row"] > 0


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_chunked_sharded_encode_on_card_matches_single_card(field, cuda_device,
                                                            tmp_path):
    """Two ranks (NCCL on two cards, Gloo sharing one) run the sharded
    encode at the narrowest lane width that chunks: PIPE_CHUNKS lane
    chunks in a wavefront, 4 exchanges each, all waited for after another
    chunk's step, and every rank the single-card encode's rows."""
    from fastecc_tpu_torch.parallel import _worker, ntt_dist
    from fastecc_tpu_torch.interop import to_numpy_u32
    chunks = ntt_dist.PIPE_CHUNKS
    k, lanes = 1 << 12, chunks * ntt_dist.PIPE_MIN_LANES
    data = _worker.seeded_u32(field.p, (k, lanes), 11, cuda_device)
    want = tmp_path / "want.npy"
    np.save(want, to_numpy_u32(rs.encode_parity(data, field)))
    del data
    reps = _worker.launch({"mesh": (2, 1), "device": "cuda", "cases": [
        {"name": "enc", "op": "encode", "field": field.name,
         "input": {"seeded": [k, lanes], "seed": 11}, "want": str(want)}]},
        2, timeout=300)
    for rep in reps:
        case = rep["cases"]["enc"]
        assert case["bit_exact"] is True
        assert case["collectives"]["all_to_all"] == 4 * chunks
        assert case["collectives"]["all_to_all_overlapped"] == 4 * chunks
        assert case["launches"]["K1_col"] > 0 and case["launches"]["K3_row"] > 0
