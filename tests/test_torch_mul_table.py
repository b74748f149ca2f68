"""The sharded codec's table multiply (``parallel.ntt_dist._mul_table`` and
``_scale``): on a CUDA tensor one launch of ``csrc/table.cu``, on a CPU
tensor the plain version (``ntt.mul_prepared``'s torch ops in row chunks),
both with one table form: a contiguous u32 word for each row.

The CPU tests hold the plain route to an independent model of the
arithmetic, the u32 tables to the strided int64 slices the codec
multiplied by before it had a card route, and the card route's launch
arguments, run through a model of the kernel's contract, to the plain
route's bits. The tests
marked ``cuda`` hold the kernel to the torch ops bit for bit on the card
and skip without one. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mul_table.py
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from fastecc_tpu_torch import fields, gf
from fastecc_tpu_torch.decode import _xderiv_consts
from fastecc_tpu_torch.ntt import _four_step_twiddles, mul_prepared
from fastecc_tpu_torch.parallel import ntt_dist as nd
from fastecc_tpu_torch.rs import _coset_twiddles_scaled

torch.set_num_threads(1)

FIELDS = [fields.GF32, fields.GF16]
D = 4


def _u32(a: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(
        np.int32)).view(torch.uint32).to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).cpu().numpy().view(np.uint32)


def _words(field, shape, seed: int) -> np.ndarray:
    """Canonical words with the edge values planted: p - 1 in GF32,
    0x10000 in GF16, and 0."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)
    flat = a.reshape(-1)
    flat[::7] = field.p - 1
    flat[3::11] = 0
    return a


def _expect(field, x: np.ndarray, prepared: np.ndarray) -> np.ndarray:
    """x * c mod p for prepared c, in Python integers (GF32's prepared
    constants are c * 2^32 mod p)."""
    r_inv = pow(1 << 32, -1, field.p) if field.use_mont else 1
    xs = x.astype(object)
    return (xs * prepared.astype(object) * r_inv % field.p).astype(np.uint32)


def _tables(field):
    """(name, build, args, row, R, C/D) of each table the sharded codec
    multiplies by, at a small size: the four-step twiddles of both
    directions, two rows of the coset table and the decode's x * d/dx."""
    n, k = 1 << 8, 1 << 6
    return [
        ("four_step_fwd", _four_step_twiddles, (field.name, n, 16, False),
         None, 16, 16 // D),
        ("four_step_inv", _four_step_twiddles, (field.name, n, 16, True),
         None, 16, 16 // D),
        ("coset_1", _coset_twiddles_scaled, (field.name, n, k), 0, 8, 8 // D),
        ("coset_3", _coset_twiddles_scaled, (field.name, n, k), 2, 8, 8 // D),
        ("xderiv", _xderiv_consts, (field.name, n), None, 16, 16 // D),
    ]


def _replaced_cut(build, args, row, r_dim, cd, j) -> torch.Tensor:
    """The strided int64 slice the sharded codec multiplied by before it
    had a card route, written as it was then."""
    t = gf.table(build(*args), "cpu")
    if build is _four_step_twiddles:
        return t[:, j * cd:(j + 1) * cd, None]
    return nd._cols_of(t if row is None else t[row], r_dim, cd, D, j)


# ---------------------------------------------------------------------------
# CPU: the plain route, the tables and the card route's arguments.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("chunk", [1 << 24, 40], ids=["one_chunk", "chunks"])
def test_plain_route_multiplies_by_the_table(field, chunk, monkeypatch):
    """On a CPU tensor ``_mul_table`` is ``mul_prepared`` over row chunks,
    and its bits are x * c mod p for each of the codec's tables (against
    the strided slice it replaces) and for a [rows] vector."""
    monkeypatch.setattr(nd, "_MUL_CHUNK", chunk)
    for i, (_, build, args, row, r_dim, cd) in enumerate(_tables(field)):
        cut = nd._table_cols(build, args, row, r_dim, cd, 1, "cpu")
        old = _replaced_cut(build, args, row, r_dim, cd, 1)
        x = _u32(_words(field, (r_dim, cd, 5), 0x7AB1 + i))
        got = nd._mul_table(field, x, cut)
        assert torch.equal(got, mul_prepared(field, x, old))
        want = _expect(field, _np(x), _np(gf.narrow(old)))
        np.testing.assert_array_equal(_np(got), want)
    v = _words(field, 12, 0x7AB0)
    x = _u32(_words(field, (12, 7), 0x7AB2))
    got = nd._mul_table(field, x, _u32(v))
    np.testing.assert_array_equal(_np(got), _expect(field, _np(x), v[:, None]))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("n", [1 << 8, 1 << 19])
def test_plain_scale_multiplies_by_one_over_n(field, n):
    x = _u32(_words(field, (9, 3, 4), 0x5CA1))
    got = nd._scale(field, x, n)
    assert torch.equal(got, gf.mul_const(field, x, field.inv_host(n)))
    want = _np(x).astype(object) * field.inv_host(n) % field.p
    np.testing.assert_array_equal(_np(got), want.astype(np.uint32))


@pytest.mark.parametrize("j", range(D))
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_card_table_is_the_strided_slice_it_replaces(field, j):
    """The contiguous u32 vector of rank j holds, row for row, the words
    of the strided int64 slice the codec multiplied by before."""
    for name, build, args, row, r_dim, cd in _tables(field):
        old = _replaced_cut(build, args, row, r_dim, cd, j)
        assert old.shape == (r_dim, cd, 1), name
        new = nd._table_cols(build, args, row, r_dim, cd, j, "cpu")
        assert new.dtype == torch.uint32 and new.is_contiguous(), name
        assert new.shape == (r_dim * cd,), name
        assert torch.equal(gf.widen(new), old.reshape(-1)), name


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_card_table_is_cached(field):
    for _, build, args, row, r_dim, cd in _tables(field):
        a = nd._table_cols(build, args, row, r_dim, cd, 2, "cpu")
        assert nd._table_cols(build, args, row, r_dim, cd, 2, "cpu") is a
    assert nd._inv_on(field, 1 << 8, "cpu") is nd._inv_on(field, 1 << 8,
                                                           "cpu")


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_prepared_inverse_is_one_word(field):
    inv = nd._inv_on(field, 1 << 10, "cpu")
    assert inv.dtype == torch.uint32 and inv.shape == (1,)
    x = _u32(_words(field, (6, 4), 0x1A7))
    np.testing.assert_array_equal(
        _np(mul_prepared(field, x, inv)),
        _np(gf.mul_const(field, x, field.inv_host(1 << 10))))


class _KernelModel:
    """Stands in for ``_build.call`` on CPU tensors: records each launch
    and runs ``fecc_mul_table``'s contract on the host memory its
    pointers address (out[m, l] = x[m, l] * table[m * stride] mod p)."""

    def __init__(self):
        self.launches = []

    def __call__(self, name, field, x, out, rows, lanes, table, stride,
                 stream):
        assert name == "fecc_mul_table" and stride in (0, 1)
        self.launches.append((field, rows, lanes, stride))

        def view(ptr, n):
            return np.ctypeslib.as_array((ctypes.c_uint32 * n).from_address(
                ptr))
        ts = view(table, rows) if stride else np.full(rows, view(table, 1))
        f = fields.GF32 if field == 0 else fields.GF16
        got = _expect(f, view(x, rows * lanes).reshape(rows, lanes),
                      ts[:, None])
        view(out, rows * lanes)[:] = got.reshape(-1)


@pytest.fixture
def card_route(monkeypatch):
    """A function that sends ``_mul_table`` and ``_scale`` on CPU tensors
    down the card route, to :class:`_KernelModel`'s launches; returns the
    model."""
    model = _KernelModel()

    def switch():
        monkeypatch.setattr(nd, "_on_card", lambda y: True)
        monkeypatch.setattr(nd._build, "call", model)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                            types.SimpleNamespace(cuda_stream=0))
        return model
    return switch


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_card_route_arguments_give_the_plain_bits(field, card_route):
    """The card route's launches (rows = y's leading axes flattened,
    lanes = its last axis, stride 1 for a table a row and 0 for the
    scale's one word), run under the kernel's contract, give the plain
    route's bits: the codec's tables, a [rows] vector, the scale, and a
    non-contiguous y."""
    cases = []      # (y, its table)
    for i, (_, build, args, row, r_dim, cd) in enumerate(_tables(field)):
        cases.append((_u32(_words(field, (r_dim, cd, 8), 0xCA2D + i)),
                      nd._table_cols(build, args, row, r_dim, cd, 3, "cpu")))
    v = _u32(_words(field, 10, 0xCA2E))
    x = _u32(_words(field, (10, 13), 0xCA2F))
    xt = _u32(_words(field, (13, 10), 0xCA30)).t()
    cases += [(x, v), (xt, v)]
    plain = [nd._mul_table(field, y, t) for y, t in cases]
    plain.append(nd._scale(field, x, 64))
    model = card_route()
    card = [nd._mul_table(field, y, t) for y, t in cases]
    card.append(nd._scale(field, x, 64))
    for got, want in zip(card, plain, strict=True):
        assert torch.equal(got, want)
    code = 0 if field.use_mont else 1
    assert model.launches == [
        (code, r_dim * cd, 8, 1) for _, _, _, _, r_dim, cd in _tables(field)
    ] + [(code, 10, 13, 1), (code, 10, 13, 1), (code, 10, 13, 0)]


def test_card_route_refuses_a_table_it_cannot_take(card_route):
    model = card_route()
    x = _u32(_words(fields.GF32, (8, 4), 0xBAD))
    for bad in (gf.widen(_u32(np.arange(8))),     # int64 carriers
                _u32(np.arange(7)),               # a word short
                _u32(np.arange(16))[::2],         # strided
                _u32(np.arange(8))[:, None]):     # not a vector
        with pytest.raises(ValueError, match="contiguous u32 table"):
            nd._mul_table(fields.GF32, x, bad)
    assert model.launches == []


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_table_muls_count_the_same_on_both_routes(field, card_route):
    """One ``mul_table`` and its elements a multiply, one ``scale`` a
    1/N, whichever route runs it."""
    x = _u32(_words(field, (8, 2, 4), 0xC0))
    counts, launches = [], []
    t = nd._twiddle_cols(field, 1 << 6, 8, False, D, 1, "cpu")
    for route in ("plain", "card"):
        if route == "card":
            card_route()
        nd.reset_collectives()
        nd._mul_table(field, x, t)
        nd._mul_table(field, x, t)
        nd._scale(field, x, 1 << 6)
        counts.append(dict(nd.TABLE_MULS))
        launches.append(dict(nd.LAUNCHES))
    assert counts[0] == counts[1] == {"mul_table": 2, "mul_table_elems": 128,
                                      "scale": 1}
    # the kernel's own count: only where it launched
    assert launches == [{"mul_table": 0}, {"mul_table": 3}]
    nd.reset_collectives()
    assert nd.LAUNCHES == {"mul_table": 0}


# ---------------------------------------------------------------------------
# On the card: the kernel against the torch ops, bit for bit.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_words(field, shape, seed: int, dev) -> torch.Tensor:
    """Canonical words drawn on the card, the edge values planted (GF32
    p - 1, GF16 0x10000, and 0)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    a = torch.randint(0, field.p, shape, dtype=torch.int64, device=dev,
                      generator=gen)
    flat = a.view(-1)
    flat[::7] = field.p - 1
    flat[3::11] = 0
    return gf.narrow(a)


def _plain(field, y, table):
    """The torch ops on the card's tensors, as the codec ran them before
    it had a card route: ``mul_prepared`` over row chunks, ``table``
    broadcast over y's trailing axes."""
    return nd._by_rows(y, lambda v, i0, i1: mul_prepared(field, v,
                                                         table[i0:i1]))


@pytest.mark.cuda
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("rows", [1, 131072])
@pytest.mark.parametrize("lanes", [8192, 4, 13])
def test_kernel_matches_mul_prepared(field, rows, lanes, cuda_device):
    """A table a row (the decode's l(w^j) form) over 1 and 2^17 rows,
    8192 lanes (the four-card cell's), 4 (one vector a row) and 13 (the
    one-word path); and the same rows 4 bytes past a 16-byte boundary,
    which must take the one-word path."""
    y = _card_words(field, (rows, lanes), rows + lanes, cuda_device)
    v = _card_words(field, (rows,), 7 * rows + lanes, cuda_device)
    got = nd._mul_table(field, y, v)
    assert torch.equal(got, _plain(field, y, v[:, None])), (rows, lanes)
    assert torch.equal(got, nd._mul_plain(field, y, v)), (rows, lanes)
    if lanes % 4 == 0 and rows * lanes <= 1 << 20:
        big = _card_words(field, (rows * lanes + 1,), 3, cuda_device)
        ys = big[1:].reshape(rows, lanes)
        assert ys.data_ptr() % 16 == 4
        assert torch.equal(nd._mul_table(field, ys, v),
                           _plain(field, ys, v[:, None])), (rows, "offset")


@pytest.mark.cuda
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_kernel_matches_mul_prepared_on_the_codec_tables(field, cuda_device):
    """The four-step slice and the coset column cut as the sharded encode
    builds them on the card (rank j of 4 at the four-card cell's order in
    GF32, k = 2^19 a transform, and at GF16's largest, k = 2^15; over 64
    lanes), against the torch ops with the strided int64 slice of the
    plain route."""
    dev = str(cuda_device)
    n = 1 << min(20, field.max_log2)
    k = n // 2
    c_dim, r_dim = nd._split_dims(k, D, None)
    for j in (0, 3):
        for inverse in (False, True):
            tw = nd._twiddle_cols(field, k, c_dim, inverse, D, j, dev)
            old = gf.table(_four_step_twiddles(field.name, k, c_dim,
                                               inverse), dev)
            old = old[:, j * (r_dim // D):(j + 1) * (r_dim // D), None]
            y = _card_words(field, (c_dim, r_dim // D, 64), 11 + j, dev)
            assert torch.equal(nd._mul_table(field, y, tw),
                               _plain(field, y, old)), (j, inverse)
        cut = nd._table_cols(_coset_twiddles_scaled, (field.name, n, k), 0,
                             r_dim, c_dim // D, j, dev)
        assert cut is nd._table_cols(_coset_twiddles_scaled,
                                     (field.name, n, k), 0, r_dim,
                                     c_dim // D, j, dev)
        tws = gf.table(_coset_twiddles_scaled(field.name, n, k), dev)
        old = nd._cols_of(tws[0], r_dim, c_dim // D, D, j)
        y = _card_words(field, (r_dim, c_dim // D, 64), 21 + j, dev)
        assert torch.equal(nd._mul_table(field, y, cut),
                           _plain(field, y, old)), j


@pytest.mark.cuda
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("shape", [(1, 4), (131072, 13), (4096, 8192)])
def test_kernel_scale_matches_mul_const(field, shape, cuda_device):
    y = _card_words(field, shape, sum(shape), cuda_device)
    for n in (1 << 8, 1 << 20):
        want = nd._by_rows(y, lambda v, i0, i1: gf.mul_const(
            field, v, field.inv_host(n)))
        assert torch.equal(nd._scale(field, y, n), want), (shape, n)


def _launched_by(prof) -> dict:
    """{span name: device operations it launched}: each device operation
    of a finished profile attributed, through its correlation id, to the
    innermost ``fecc.`` span around its launch record on the host."""
    spans, launches, ops = [], {}, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith("fecc."):
                ops.append(ev.correlation_id())
        elif name.startswith("fecc."):
            spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                          name))
        elif name.startswith(("cudaLaunchKernel", "cuLaunchKernel",
                              "cudaMemsetAsync", "cudaMemcpyAsync")):
            launches[ev.correlation_id()] = ev.start_ns()
    counts: dict = {}
    for corr in ops:
        t = launches.get(corr)
        around = [(s, n) for s, e, n in spans if t is not None and s <= t < e]
        if around:
            name = max(around)[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_profiled_sharded_call_launches_one_op_a_multiply(field, cuda_device,
                                                          tmp_path):
    """A one-rank NCCL world on the card: under the profiler, every
    ``fecc.dist.mul_table`` and ``fecc.dist.scale`` of the sharded encode
    and decode launched exactly one device operation, and the outputs are
    the unprofiled call's."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from fastecc_tpu_torch.parallel import mesh

    mesh.init_process_group(0, 1, tmp_path / "store", device="cuda",
                            timeout=120)
    try:
        m = mesh.make_mesh(1, 1)
        k, lanes = 1 << 12, 64
        data = _card_words(field, (k, lanes), 0xD15, cuda_device)
        erased = np.arange(0, 2 * k, 3)[:k]
        cw = torch.empty((2 * k, lanes), dtype=torch.int32,
                         device=cuda_device)
        cw[0::2] = data.view(torch.int32)
        cw[1::2] = nd.encode_parity_sharded(data, field, m).view(torch.int32)
        whole = cw.clone()
        cw[torch.from_numpy(erased).to(cuda_device)] = 12345
        calls = {
            "enc": lambda: nd.encode_parity_sharded(data, field, m),
            "dec": lambda: nd.decode_sharded(cw.view(torch.uint32), erased,
                                             field, m)}
        # (table multiplies, 1/N scales) a call at Dc = 1: the encode's
        # coset table; the decode's l(w^j), x * d/dx and Forney, its 1/N
        want = {"enc": (1, 0), "dec": (3, 1)}
        for op, fn in calls.items():
            first = fn()
            torch.cuda.synchronize()
            nd.reset_collectives()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = fn()
                torch.cuda.synchronize()
            assert torch.equal(out.view(torch.int32), first.view(torch.int32))
            muls, scales = want[op]
            assert nd.TABLE_MULS["mul_table"] == muls
            assert nd.TABLE_MULS["scale"] == scales
            got = _launched_by(prof)
            assert got.get("fecc.dist.mul_table", 0) == muls, (op, got)
            assert got.get("fecc.dist.scale", 0) == scales, (op, got)
        assert torch.equal(calls["dec"]().view(torch.int32), whole)
    finally:
        dist.destroy_process_group()
