"""The GF32 escape pack (``kernels.pack.pack_gf32``, which
``packing.pack_data`` and ``pack_data_pairs`` call for GF32): on a CUDA
tensor one launch of ``csrc/pack.cu``, on a CPU tensor the plain version
(``pack_gf32_plain``, int64 torch ops).

The CPU tests hold the plain version to an independent model of the wire
format, the wrapper's refusals, and the card route's launch arguments, run
through a model of the kernel's contract, to the plain version's bits and
to one launch a pack. The tests marked ``cuda`` hold the kernel to the
plain version bit for bit on the card and skip without one. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pack_kernel.py
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from fastecc_tpu_torch import gf, packing, rs
from fastecc_tpu_torch.fields import GF16, GF32
from fastecc_tpu_torch.kernels import pack as pk

torch.set_num_threads(1)

P = GF32.p
NEAR = np.array([P - 4, P - 3, P - 2, P - 1, P, P + 1, P + 2, P + 3,
                 0xFFFFFFFE, 0xFFFFFFFF, 0, 1], np.uint64)
# words a row: vectors (W and W + ceil(W/16) divide by 4: 60, 64, 1024),
# one word a thread (the rest), and bitmap words with trailing bits
WIDTHS = [1, 2, 4, 8, 15, 16, 17, 25, 60, 64, 100, 1024]


def _u32(a: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(
        np.int32)).view(torch.uint32).to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).cpu().numpy().view(np.uint32)


def _words(shape, seed: int) -> np.ndarray:
    """Words near p and at the ends of the range, a third of the rows
    uniform, the second row all 0xFFFFFFFF."""
    rng = np.random.default_rng(seed)
    a = rng.choice(NEAR, shape).astype(np.uint32)
    flat = a.reshape(-1, shape[-1])
    flat[2::3] = rng.integers(0, 1 << 32, flat[2::3].shape,
                              dtype=np.uint64).astype(np.uint32)
    if flat.shape[0] > 1:
        flat[1] = 0xFFFFFFFF
    return a


def _expect(words: np.ndarray) -> np.ndarray:
    """The wire format in Python integers: w - p where w >= p, then bit j
    of bitmap word m set iff word 16m + j escaped."""
    w = words.reshape(-1, words.shape[-1])
    out = []
    for row in w.tolist():
        esc = [x >= P for x in row]
        bitmap = [sum(1 << j for j, e in enumerate(esc[m:m + 16]) if e)
                  for m in range(0, len(row), 16)]
        out.append([x - P if e else x for x, e in zip(row, esc)] + bitmap)
    return np.array(out, np.uint32).reshape(words.shape[:-1] + (-1,))


# ---------------------------------------------------------------------------
# CPU: the plain version, the refusals and the card route's arguments.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("words", WIDTHS)
def test_plain_version_is_the_wire_format(words):
    x = _words((7, words), 0x9AC + words)
    got = pk.pack_gf32(_u32(x))
    assert got.dtype == torch.uint32
    assert tuple(got.shape) == (7, words + -(-words // 16))
    np.testing.assert_array_equal(_np(got), _expect(x))
    assert torch.equal(got, pk.pack_gf32_plain(_u32(x)))


def test_plain_version_packs_leading_axes_as_rows():
    x = _words((3, 4, 20), 0x3D)
    got = pk.pack_gf32(_u32(x))
    assert tuple(got.shape) == (3, 4, 22)
    np.testing.assert_array_equal(_np(got), _expect(x))


@pytest.mark.parametrize("bad", [
    torch.zeros((4, 8), dtype=torch.int32),
    torch.zeros((4, 8), dtype=torch.int64),
    torch.zeros((4, 32), dtype=torch.uint8),
    torch.zeros(8, dtype=torch.uint32),
    torch.zeros((), dtype=torch.uint32)],
    ids=["int32", "int64", "uint8", "rank1", "rank0"])
def test_wrapper_refuses_what_it_cannot_pack(bad):
    before = dict(pk.LAUNCHES)
    with pytest.raises(ValueError, match="u32 words of rank 2"):
        pk.pack_gf32(bad)
    assert pk.LAUNCHES == before


def test_wrapper_refuses_another_device():
    """A tensor neither on the CPU nor on a CUDA device raises before any
    launch, as the other kernels' wrappers do."""
    x = torch.empty((4, 8), dtype=torch.uint32, device="meta")
    before = dict(pk.LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device meta"):
        pk.pack_gf32(x)
    assert pk.LAUNCHES == before


class _KernelModel:
    """Stands in for ``_build.call`` on CPU tensors: records each launch
    and runs ``fecc_pack_gf32``'s contract on the host memory its pointers
    address (out [rows, W + ceil(W/16)] from x [rows, W])."""

    def __init__(self):
        self.launches = []

    def __call__(self, name, x, out, rows, words, stream):
        assert name == "fecc_pack_gf32"
        self.launches.append((rows, words))

        def view(ptr, n):
            return np.ctypeslib.as_array((ctypes.c_uint32 * n).from_address(
                ptr))
        lanes = words + -(-words // 16)
        got = _expect(view(x, rows * words).reshape(rows, words))
        view(out, rows * lanes)[:] = got.reshape(-1)


@pytest.fixture
def card_route(monkeypatch):
    """A function that sends ``pack_gf32`` on CPU tensors down the card
    route, to :class:`_KernelModel`'s launches; returns the model."""
    model = _KernelModel()

    def switch():
        monkeypatch.setattr(pk, "_on_card", lambda words: True)
        monkeypatch.setattr(pk._build, "call", model)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                            types.SimpleNamespace(cuda_stream=0))
        return model
    return switch


def test_card_route_arguments_give_the_plain_bits(card_route):
    """The card route's launches (rows = the leading axes flattened, words
    = the last axis, a contiguous copy of a strided input), run under the
    kernel's contract, give the plain version's bits, one launch a call."""
    cases = [_u32(_words((5, w), 0xCA + w)) for w in (1, 25, 60, 1024)]
    cases.append(_u32(_words((3, 2, 17), 0xCB)))
    cases.append(_u32(_words((40, 6), 0xCC)).t())          # strided
    plain = [pk.pack_gf32(x) for x in cases]
    model = card_route()
    pk.reset_launches()
    card = [pk.pack_gf32(x) for x in cases]
    for got, want in zip(card, plain, strict=True):
        assert torch.equal(got, want)
    assert model.launches == [(5, 1), (5, 25), (5, 60), (5, 1024), (6, 17),
                              (6, 40)]
    assert pk.LAUNCHES == {"pack_gf32": 6}
    pk.reset_launches()
    assert pk.LAUNCHES == {"pack_gf32": 0}


def test_packing_takes_the_kernel_once_a_gf32_pack(card_route):
    """``pack_data`` and ``pack_data_pairs`` in GF32 launch the kernel
    once a call, beside one count in ``packing.PACKED``, with the plain
    route's bits; GF16's packs launch nothing."""
    raw = torch.from_numpy(_words((16, 16), 0xDA).view(np.uint8).copy())
    words = raw.view(torch.uint32)
    plain = (packing.pack_data(raw, GF32),
             packing.pack_data_pairs(words, GF32))
    card_route()
    pk.reset_launches()
    packing.reset_packed()
    assert torch.equal(packing.pack_data(raw, GF32), plain[0])
    assert pk.LAUNCHES["pack_gf32"] == 1 and packing.PACKED["pack"] == 1
    assert torch.equal(packing.pack_data_pairs(words, GF32), plain[1])
    assert pk.LAUNCHES["pack_gf32"] == 2
    packing.pack_data(raw, GF16)
    packing.pack_data_pairs(words, GF16)
    assert pk.LAUNCHES["pack_gf32"] == 2
    pk.reset_launches()
    packing.reset_packed()


# ---------------------------------------------------------------------------
# On the card: the kernel against the plain version, bit for bit.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _launch_once(x: torch.Tensor) -> torch.Tensor:
    before = pk.LAUNCHES["pack_gf32"]
    out = pk.pack_gf32(x)
    assert pk.LAUNCHES["pack_gf32"] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("words", WIDTHS)
@pytest.mark.parametrize("rows", [1, 37, 4099])
def test_kernel_matches_plain(words, rows, cuda_device):
    """Every width at rows that fill no block, one and many; the same
    words 4 bytes past a 16-byte boundary (one word a thread)."""
    x = _u32(_words((rows, words), rows * words), cuda_device)
    got = _launch_once(x)
    assert torch.equal(got, pk.pack_gf32_plain(x)), (rows, words)
    if rows == 37:
        np.testing.assert_array_equal(_np(got), _expect(_np(x)))
    buf = torch.empty(rows * words + 1, dtype=torch.int32,
                      device=cuda_device)
    xs = buf[1:].view(torch.uint32).reshape(rows, words)
    xs.view(torch.int32).copy_(x.view(torch.int32))
    assert xs.data_ptr() % 16 == 4
    assert torch.equal(_launch_once(xs), got), (rows, words, "offset")


@pytest.mark.cuda
def test_kernel_matches_plain_on_strided_and_stacked_words(cuda_device):
    x = _u32(_words((6, 40, 64), 0x57), cuda_device)
    assert torch.equal(_launch_once(x), pk.pack_gf32_plain(x))
    xt = x[1].t()
    assert torch.equal(_launch_once(xt), pk.pack_gf32_plain(xt))


@pytest.mark.cuda
def test_kernel_past_two_gib(cuda_device):
    """The cell's width at 2^19 + 3 rows: 2 GiB and more of words, so the
    element offsets pass 2^31 bytes; the first and last rows against the
    plain version on just those rows, and every row in chunks."""
    rows, words = (1 << 19) + 3, 1024
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0xB16)
    x = torch.randint(0, 1 << 32, (rows, words), dtype=torch.int64,
                      device=cuda_device, generator=gen)
    x[1::64] = 0xFFFFFFFF
    x[-1] = 0xFFFFFFFF
    x[-3, ::7] = P
    x = gf.narrow(x)
    got = _launch_once(x)
    assert tuple(got.shape) == (rows, 1088)
    for sl in (slice(0, 5), slice(rows - 5, rows)):
        assert torch.equal(got[sl], pk.pack_gf32_plain(x[sl].contiguous()))
    assert set(_np(got[-1, 1024:]).tolist()) == {0xFFFF}
    step = 1 << 16
    for r0 in range(0, rows, step):
        assert torch.equal(got[r0:r0 + step],
                           pk.pack_gf32_plain(x[r0:r0 + step])), r0


@pytest.mark.cuda
def test_profiled_encode_blocks_launches_one_op_a_pack(cuda_device):
    """``rs.encode_blocks(GF32)`` on the card under the profiler: the
    span ``fecc.packing.pack_data`` launched exactly one device operation,
    the kernel counted it once, and the bytes are the unprofiled call's
    and the CPU's."""
    from torch.profiler import ProfilerActivity, profile

    from test_torch_mul_table import _launched_by

    raw = _words((256, 1024), 0xE2).view(np.uint8).reshape(256, 4096)
    x = torch.from_numpy(raw.copy()).to(cuda_device)
    first = rs.encode_blocks(x, GF32)
    torch.cuda.synchronize()
    pk.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = rs.encode_blocks(x, GF32)
        torch.cuda.synchronize()
    assert pk.LAUNCHES == {"pack_gf32": 1}
    assert _launched_by(prof).get("fecc.packing.pack_data", 0) == 1
    assert torch.equal(out, first)
    assert torch.equal(out.cpu(), rs.encode_blocks(x.cpu(), GF32))
