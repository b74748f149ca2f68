"""Port vs reference: the native host binding (fastecc_tpu_torch.host vs
fastecc_tpu.host) on the same arrays in both fields, against the port's
own plain twins (packing on CPU tensors, the numpy CRC32C, ntt_host), the
decode's native branches, and the port's build: its own path under
build/torch_kernels/, whole under concurrent builds, and never the
reference's build/libfastecc_host.so."""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from fastecc_tpu import host as jhost
from fastecc_tpu import ntt as jntt
from fastecc_tpu_torch import decode, fields, host, packing
from fastecc_tpu_torch.interop import from_numpy_u32, to_numpy_u32
from fastecc_tpu_torch.ntt import ntt_host

torch.set_num_threads(1)

GF32, GF16 = fields.GF32, fields.GF16
ROOT = Path(__file__).resolve().parent.parent
FIELD_IDS = dict(ids=lambda f: f.name)


def _jf(field):
    from fastecc_tpu.fields import FIELDS
    return FIELDS[field.name]


@pytest.fixture(scope="module")
def port():
    if not host.build():
        pytest.skip("no C++ compiler: the native host library cannot build")
    return host


@pytest.fixture
def ref(port, monkeypatch):
    """The reference's binding. Where its library is not loaded, it loads
    the port's build of the same source: the reference's own build()
    runs `make -B` into one shared path, which other test processes may
    be loading at that moment."""
    if not jhost.available():
        monkeypatch.setattr(jhost, "_SO", host._target())
        monkeypatch.setattr(jhost, "_lib", None)
        assert jhost.available()
    return jhost


def _raw(rng, k, block_bytes=4096):
    raw = rng.integers(0, 256, (k, block_bytes), dtype=np.uint16).astype(
        np.uint8)
    raw[0, :] = 0xFF                       # every GF32 word escapes
    return raw


@pytest.mark.parametrize("field", [GF32, GF16], **FIELD_IDS)
def test_pack_unpack_match_reference_and_plain(port, ref, field):
    raw = _raw(np.random.default_rng(0x407), 33)
    got = port.pack_data(raw, field)
    np.testing.assert_array_equal(got, ref.pack_data(raw, _jf(field)))
    np.testing.assert_array_equal(
        got, to_numpy_u32(packing.pack_data(torch.from_numpy(raw), field)))
    back = port.unpack_data(got, field)
    np.testing.assert_array_equal(back, ref.unpack_data(got, _jf(field)))
    np.testing.assert_array_equal(back, raw)
    np.testing.assert_array_equal(
        back, packing.unpack_data(from_numpy_u32(got, "cpu"), field).numpy())


@pytest.mark.parametrize("field", [GF32, GF16], **FIELD_IDS)
def test_parity_serialization_matches_reference_and_plain(port, ref, field):
    rng = np.random.default_rng(0x5E7)
    lanes = packing.field_lanes(field)
    vals = rng.integers(0, field.p, (17, lanes), dtype=np.uint64).astype(
        np.uint32)
    if not field.use_mont:
        vals[0, :7] = 0x10000               # the GF16 escape value
        vals[1, ::3] = 0x10000
    blob = port.serialize_parity(vals, field)
    np.testing.assert_array_equal(blob,
                                  ref.serialize_parity(vals, _jf(field)))
    np.testing.assert_array_equal(
        blob, packing.serialize_parity(from_numpy_u32(vals, "cpu"),
                                       field).numpy())
    back = port.deserialize_parity(blob, field)
    np.testing.assert_array_equal(back,
                                  ref.deserialize_parity(blob, _jf(field)))
    np.testing.assert_array_equal(back, vals)
    np.testing.assert_array_equal(
        back, to_numpy_u32(packing.deserialize_parity(torch.from_numpy(blob),
                                                      field)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(64, 3), (256,), (1024, 2), (2, 5)])
@pytest.mark.parametrize("field", [GF32, GF16], **FIELD_IDS)
def test_ntt_matches_reference_and_ntt_host(port, ref, field, shape,
                                            inverse):
    x = np.random.default_rng(7).integers(0, field.p, shape,
                                          dtype=np.uint64).astype(np.uint32)
    got = port.ntt(x, field, inverse=inverse)
    np.testing.assert_array_equal(got, ref.ntt(x, _jf(field),
                                               inverse=inverse))
    np.testing.assert_array_equal(got, ntt_host(x, field, inverse=inverse))
    np.testing.assert_array_equal(
        got, jntt.ntt_host(x, _jf(field), inverse=inverse))


@pytest.mark.parametrize("field", [GF32, GF16], **FIELD_IDS)
def test_mulmod_matches_reference_and_numpy(port, ref, field):
    rng = np.random.default_rng(0x3A)
    a = rng.integers(0, field.p, (8, 513), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, field.p, (8, 513), dtype=np.uint64).astype(np.uint32)
    want = (a.astype(np.uint64) * b % np.uint64(field.p)).astype(np.uint32)
    got = port.mulmod(a, b, field)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref.mulmod(a, b, _jf(field)))
    with pytest.raises(ValueError, match="shapes"):
        port.mulmod(a, b[:, :5], field)


@pytest.mark.parametrize("width", [4096, 4352, 1000, 1])
def test_crc32c_matches_reference_and_numpy_twin(port, ref, width):
    assert port.crc32c(b"123456789") == 0xE3069283   # RFC 3720 vector
    assert port.crc32c_np(b"123456789") == 0xE3069283
    rng = np.random.default_rng(11 + width)
    blocks = rng.integers(0, 256, (9, width), dtype=np.uint16).astype(
        np.uint8)
    tags = port.crc32c_blocks(blocks)
    np.testing.assert_array_equal(tags, ref.crc32c_blocks(blocks))
    np.testing.assert_array_equal(tags, port.crc32c_blocks_np(blocks))
    np.testing.assert_array_equal(tags, jhost.crc32c_blocks_np(blocks))
    for row, t in zip(blocks, tags):
        assert port.crc32c(row.tobytes()) == ref.crc32c(row.tobytes()) == t
        assert port.crc32c_np(row) == t


def test_wrappers_reject_nondefault_widths(port):
    """The C++ functions hardcode the 4 KB wire format: any other width
    raises instead of reading out of bounds or truncating."""
    for field in (GF32, GF16):
        with pytest.raises(ValueError, match="wire format"):
            port.pack_data(np.zeros((2, 2048), np.uint8), field)
        with pytest.raises(ValueError, match="wire format"):
            port.unpack_data(np.zeros((2, 64), np.uint32), field)
        with pytest.raises(ValueError, match="wire format"):
            port.serialize_parity(np.zeros((2, 64), np.uint32), field)
        with pytest.raises(ValueError, match="wire format"):
            port.deserialize_parity(np.zeros((2, 64), np.uint8), field)


@pytest.mark.parametrize("field", [GF32, GF16], **FIELD_IDS)
def test_decode_native_branches_keep_every_bit(port, monkeypatch, field):
    """locator_host (host.ntt, host.mulmod) and survivors_to_codeword
    (host.pack_data, host.deserialize_parity) give the numpy/plain
    branches' bits, and decode_blocks the raw data either way."""
    from fastecc_tpu_torch import rs
    rng = np.random.default_rng(0xDEC)
    n = 64
    erased = np.sort(rng.choice(n, 21, replace=False))
    k = 16
    raw = _raw(rng, k)
    parity = rs.encode_blocks(torch.from_numpy(raw), field, 2 * k).numpy()
    dpos, ppos = rs.data_positions(2 * k, k), rs.parity_positions(2 * k, k)
    keep = rng.choice(2 * k, k, replace=False)
    surv = {int(q): (raw[q // 2] if q % 2 == 0 else
                     parity[int(np.flatnonzero(ppos == q)[0])]).tobytes()
            for q in keep}
    assert len(dpos) == k
    native = (decode.locator_host(erased, n, field),
              decode.survivors_to_codeword(surv, 2 * k, k, field),
              decode.decode_blocks(surv, 2 * k, k, field, device="cpu"))
    monkeypatch.setattr(host, "available", lambda: False)
    plain = (decode.locator_host(erased, n, field),
             decode.survivors_to_codeword(surv, 2 * k, k, field),
             decode.decode_blocks(surv, 2 * k, k, field, device="cpu"))
    for a, b in zip(native[0] + native[1], plain[0] + plain[1]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(native[2], plain[2])
    np.testing.assert_array_equal(native[2].numpy(), raw)


def _copy_port(dst: Path) -> Path:
    """A copy of the package and the native source under ``dst``, with
    no build directory: the port's build runs there as in a checkout."""
    shutil.copytree(ROOT / "fastecc_tpu_torch", dst / "fastecc_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "native").mkdir()
    shutil.copy(ROOT / "native" / "fastecc_host.cpp", dst / "native")
    return dst


_BUILD_AND_CHECK = textwrap.dedent("""
    import sys
    import numpy as np
    from fastecc_tpu_torch import host, packing
    from fastecc_tpu_torch.fields import GF32, GF16
    assert host.build(), "build failed"
    rng = np.random.default_rng(int(sys.argv[1]))
    raw = rng.integers(0, 256, (8, 4096), dtype=np.uint16).astype(np.uint8)
    for f in (GF32, GF16):
        assert (host.unpack_data(host.pack_data(raw, f), f) == raw).all()
    assert host.crc32c(b"123456789") == 0xE3069283
    print("LOADED", host._lib._name)
""")


def _run(code: str, cwd: Path, arg: int):
    return subprocess.Popen(
        [sys.executable, "-c", code, str(arg)], cwd=cwd,
        env={**os.environ, "PYTHONPATH": str(cwd)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_concurrent_builds_each_load_a_whole_library(port, tmp_path):
    """Six processes build into an empty build directory at once: each
    loads a whole library (a temporary file, os.replace-d into place),
    all the same path, and no temporary file is left behind."""
    repo = _copy_port(tmp_path)
    procs = [_run(_BUILD_AND_CHECK, repo, i) for i in range(6)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    loaded = {o.split("LOADED ")[1].strip() for o in outs}
    assert len(loaded) == 1, loaded
    built = sorted(p.name
                   for p in (repo / "build" / "torch_kernels").iterdir())
    assert len(built) == 1 and built[0].startswith("libfastecc_host_"), built
    assert Path(loaded.pop()).name == built[0]


def test_port_never_touches_the_reference_library(port, tmp_path):
    """The port builds and loads only under build/torch_kernels/: a
    reference library at build/libfastecc_host.so keeps its mtime, inode
    and bytes (it is not even a library here: loading it would fail)."""
    repo = _copy_port(tmp_path)
    ref_so = repo / "build" / "libfastecc_host.so"
    ref_so.parent.mkdir()
    ref_so.write_bytes(b"not a library: the port must not open it")
    os.utime(ref_so, ns=(1_000_000_000, 1_000_000_000))
    before = ref_so.stat()
    p = _run(_BUILD_AND_CHECK, repo, 3)
    out = p.communicate(timeout=240)[0]
    assert p.returncode == 0, out
    after = ref_so.stat()
    assert (after.st_ino, after.st_mtime_ns, after.st_size) == (
        before.st_ino, before.st_mtime_ns, before.st_size)
    assert f"{repo}/build/torch_kernels/libfastecc_host_" in out
