"""Port vs reference: the file layer (fastecc_tpu_torch.storage vs
fastecc_tpu.storage) on the CPU, tolerance 0: byte-identical directories
and manifests in both fields (4 KB and odd block sizes, empty and tiny
files, the striped layout with a one-block tail stripe), each package
recovering the other's directory, equal audit reports, the same streamed
syndrome draws under one entropy, equal updates and ranged reads, and the
staging files reaped when a recover fails."""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from fastecc_tpu import storage as jstorage
from fastecc_tpu.fields import FIELDS as JFIELDS
from fastecc_tpu_torch import fields, host, rs, storage

torch.set_num_threads(1)

GF32, GF16 = fields.GF32, fields.GF16
FIELD_IDS = dict(ids=lambda f: f.name)


def _payload(path: Path, size: int, seed: int) -> Path:
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size, dtype=np.uint16).astype(np.uint8)
    data[: min(size, 64)] = 0xFF          # GF32 escapes in block 0
    path.write_bytes(data.tobytes())
    return path


def _tree(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _assert_same_tree(a: Path, b: Path) -> None:
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for name in ta:
        assert ta[name] == tb[name], name


def _block_files(d: Path) -> list:
    return sorted(d.glob("block_*.dat")) + sorted(d.glob("block_*.par"))


def _lose_max(d: Path, man: dict, rng) -> None:
    """Delete n - k block files of every codeword under ``d``."""
    for st in (man["stripes"] if storage.is_striped(man) else [man]):
        sd = d / st["dir"] if storage.is_striped(man) else d
        files = _block_files(sd)
        for i in rng.choice(len(files), st["n"] - st["k"], replace=False):
            files[i].unlink()


CASES = {
    # name: (size, block_bytes, stripe_blocks)
    "4k": (5 * 4096 + 123, 4096, None),
    "odd-block": (37 * 1000 + 5, 1000, None),
    "empty": (0, 4096, None),
    "tiny": (17, 4096, None),
    "striped-1-block-tail": (2 * 4 * 4096 + 1, 4096, 4),
    "striped": (19 * 4096 + 7, 4096, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("field", [GF32, GF16], **FIELD_IDS)
def test_encode_matches_reference_and_recovers_across(tmp_path, field,
                                                      case):
    size, bb, sb = CASES[case]
    src = _payload(tmp_path / "in.bin", size, len(case))
    jman = jstorage.encode_file(src, tmp_path / "ref", JFIELDS[field.name],
                                block_bytes=bb, stripe_blocks=sb,
                                max_resident_bytes=1 << 16)
    man = storage.encode_file(src, tmp_path / "port", field, block_bytes=bb,
                              stripe_blocks=sb, max_resident_bytes=1 << 16,
                              device="cpu")
    assert man == jman
    assert (tmp_path / "port" / "manifest.json").read_text() == json.dumps(
        jman)
    _assert_same_tree(tmp_path / "ref", tmp_path / "port")
    rng = np.random.default_rng(size)
    for d in ("ref", "port"):
        _lose_max(tmp_path / d, man, rng)
    storage.recover_file(tmp_path / "ref", tmp_path / "a.bin", device="cpu")
    jstorage.recover_file(tmp_path / "port", tmp_path / "b.bin")
    assert (tmp_path / "a.bin").read_bytes() == src.read_bytes()
    assert (tmp_path / "b.bin").read_bytes() == src.read_bytes()


@pytest.mark.parametrize("field", [GF32, GF16], **FIELD_IDS)
def test_stream_encode_bytes_do_not_depend_on_the_chunking(tmp_path, field):
    """Every word chunk (one 16-word bitmap group, a few, the whole axis)
    gives the reference's in-core bytes."""
    src = _payload(tmp_path / "in.bin", 9 * 4096 + 99, 3)
    jstorage.encode_file_stream(src, tmp_path / "ref", JFIELDS[field.name])
    words = 1024 if field.use_mont else 2048
    for cw in (16, 256, words):
        out = tmp_path / f"cw{cw}"
        storage.encode_file_stream(src, out, field, chunk_words=cw,
                                   device="cpu")
        _assert_same_tree(tmp_path / "ref", out)


def _encode_both(tmp_path, field, size, seed, sb=None):
    src = _payload(tmp_path / "in.bin", size, seed)
    jstorage.encode_file(src, tmp_path / "ref", JFIELDS[field.name],
                         stripe_blocks=sb)
    man = storage.encode_file(src, tmp_path / "port", field,
                              stripe_blocks=sb, device="cpu")
    return src, man


def _both(tmp_path, fn):
    for d in ("ref", "port"):
        fn(tmp_path / d)


def _check_both(tmp_path):
    jrep = jstorage.check_file(tmp_path / "ref")
    rep = storage.check_file(tmp_path / "port", device="cpu")
    assert rep == jrep
    return rep


def test_check_reports_match_reference(tmp_path, monkeypatch):
    """check_file on the audit states of the reference's own tests:
    healthy, degraded, unrecoverable, corrupt-located (a forged CRC),
    CRC and size anomalies flagged; then the striped aggregate. The
    located positions come from OS-entropy combos in both packages and
    must agree."""
    _encode_both(tmp_path, GF32, 6 * 4096 + 5, 11)
    man = json.loads((tmp_path / "port" / "manifest.json").read_text())
    n, k = man["n"], man["k"]
    assert _check_both(tmp_path)[0]["status"] == "healthy"

    victim = _block_files(tmp_path / "port")[k].name     # a parity file
    saved = (tmp_path / "port" / victim).read_bytes()
    _both(tmp_path, lambda d: (d / victim).unlink())
    assert _check_both(tmp_path)[0]["status"] == "degraded"
    _both(tmp_path, lambda d: (d / victim).write_bytes(saved))

    names = [f.name for f in _block_files(tmp_path / "port")][: n - k + 1]
    blobs = {nm: (tmp_path / "port" / nm).read_bytes() for nm in names}
    _both(tmp_path, lambda d: [(d / nm).unlink() for nm in names])
    rep, rc = _check_both(tmp_path)
    assert (rc, rep["status"]) == (2, "unrecoverable")
    _both(tmp_path, lambda d: [(d / nm).write_bytes(b)
                               for nm, b in blobs.items()])

    # a data block flipped with its manifest CRC forged: only the
    # algebraic audit sees it
    d2 = sorted((tmp_path / "port").glob("block_*.dat"))[2]
    pos = int(d2.stem.split("_")[1])
    raw = bytearray(d2.read_bytes())
    raw[7] ^= 0x55
    man["crc32c"][str(pos)] = int(host.crc32c(bytes(raw)))

    def forge(d):
        (d / d2.name).write_bytes(bytes(raw))
        (d / "manifest.json").write_text(json.dumps(man))
    _both(tmp_path, forge)
    rep, rc = _check_both(tmp_path)
    assert (rc, rep["status"], rep["located_corrupt"]) == (
        1, "corrupt-located", [pos])

    # a CRC mismatch (tag not forged) and a truncated block, both flagged
    d0, d1 = sorted((tmp_path / "port").glob("block_*.dat"))[:2]
    bad = bytearray(d0.read_bytes())
    bad[0] ^= 1

    def damage(d):
        (d / d0.name).write_bytes(bytes(bad))
        (d / d1.name).write_bytes((d / d1.name).read_bytes()[:100])
    _both(tmp_path, damage)
    rep, rc = _check_both(tmp_path)
    assert {why.split()[0] for _, why in rep["flagged"]} == {"CRC", "bad"}

    # striped: one stripe degraded, one healthy, the manifest of a third
    # lost
    for d in ("ref", "port"):
        shutil.rmtree(tmp_path / d)
    _encode_both(tmp_path, GF16, 20 * 4096 + 3, 12, sb=8)

    def stripes(d):
        (d / "stripe_0001" / "block_000001.par").unlink()
        (d / "stripe_0002" / "manifest.json").unlink()
    _both(tmp_path, stripes)
    rep, rc = _check_both(tmp_path)
    assert rep["striped"] and rc == 1


def _staged_codeword(field, n, k, lanes, rows, seed):
    """An [n, lanes] codeword as a host array with ``rows`` corrupted."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, field.p, (k, lanes), dtype=np.uint64).astype(
        np.uint32)
    from fastecc_tpu_torch.interop import to_numpy_u32
    cw = to_numpy_u32(rs.encode(data, field, n, device="cpu")).copy()
    for r in rows:
        cw[r, rng.integers(lanes)] ^= 1
        cw[r] %= field.p
    return cw


@pytest.mark.parametrize("erased", [0, 5])
@pytest.mark.parametrize("field", [GF32, GF16], **FIELD_IDS)
def test_streamed_locate_same_entropy_same_draws(monkeypatch, field,
                                                 erased):
    """_streamed_locate in both packages, one entropy: the same combo
    draws give the same accumulated syndromes over every lane chunk and
    the same located rows (with and without known erasures)."""
    n, k, lanes, cl = 64, 32, 24, 8
    rows = [3, 40, 61]
    cw = _staged_codeword(field, n, k, lanes, rows, seed=erased + 1)
    er = np.array(sorted({7, 8, 20, 33, 50}) if erased else [], np.int64)
    if erased:
        cw[er] = 0                          # the erased rows hold garbage
    seen = {}
    from fastecc_tpu import decode as jdec
    from fastecc_tpu_torch import decode as dec
    for name, mod in (("ref", jdec), ("port", dec)):
        real = mod._bm_locate

        def spy(s1, s2, *a, _real=real, _name=name, **kw):
            seen[_name] = (s1.copy(), s2.copy())
            return _real(s1, s2, *a, **kw)
        monkeypatch.setattr(mod, "_bm_locate", spy)
    jpos = jstorage._streamed_locate(cw, er, JFIELDS[field.name], n, k,
                                     lanes, cl, entropy=0x5EED)
    pos = storage._streamed_locate(cw, er, field, n, k, lanes, cl,
                                   entropy=0x5EED, device="cpu")
    for a, b in zip(seen["ref"], seen["port"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(pos, rows)


@pytest.mark.parametrize("field", [GF32, GF16], **FIELD_IDS)
def test_update_and_read_match_reference(tmp_path, field):
    """update_file leaves the port's directory identical to the
    reference's after the same edits (one within a codeword, one across
    a stripe seam, one that changes nothing), and read_file serves the
    reference's bytes, healthy and degraded."""
    for sb in (None, 4):
        root = tmp_path / f"sb{sb}"
        root.mkdir()
        src, man = _encode_both(root, field, 11 * 4096 + 777, 21, sb=sb)
        payload = bytearray(src.read_bytes())
        edits = [(3 * 4096 - 100, bytes(range(256)) * 20),
                 (len(payload) - 3, b"\xFF\x00\xEE"),
                 (10, bytes(payload[10:20]))]
        for off, data in edits:
            payload[off: off + len(data)] = data
            got = storage.update_file(root / "port", off, data,
                                      device="cpu")
            assert got == jstorage.update_file(root / "ref", off, data)
        _assert_same_tree(root / "ref", root / "port")
        ranges = [(5000, 3000), (0, 1), (len(payload) - 7, 7), (100, 0),
                  (4 * 4096 - 10, 20)]
        for off, ln in ranges:
            assert storage.read_file(root / "port", off, ln,
                                     device="cpu") == payload[off:off + ln]
        # degraded: the data blocks covering [4096, 16384) of every
        # codeword and one parity file are gone
        for d in ("ref", "port"):
            for sub in ([root / d] if sb is None else
                        sorted((root / d).glob("stripe_*"))):
                for q in (2, 4, 6):
                    (sub / f"block_{q:06d}.dat").unlink(missing_ok=True)
                (sub / "block_000001.par").unlink(missing_ok=True)
        for off, ln in ranges:
            want = jstorage.read_file(root / "ref", off, ln)
            assert want == payload[off:off + ln]
            assert storage.read_file(root / "port", off, ln,
                                     device="cpu") == want


def test_reader_matches_read_file(tmp_path):
    """Reader (cached scan, tables, windows and descriptors) serves what
    read_file serves, on a degraded striped directory, twice over."""
    src, man = _encode_both(tmp_path, GF32, 13 * 4096 + 5, 31, sb=8)
    payload = src.read_bytes()
    for sub in sorted((tmp_path / "port").glob("stripe_*")):
        for q in (0, 4):
            (sub / f"block_{q:06d}.dat").unlink(missing_ok=True)
    ranges = [(0, 5000), (7 * 4096, 4096 + 50), (30, 1), (8 * 4096, 9000)]
    with storage.Reader(tmp_path / "port", device="cpu") as rd:
        for _ in range(2):
            for off, ln in ranges:
                got = rd.read(off, ln)
                assert got == payload[off:off + ln]
                assert got == storage.read_file(tmp_path / "port", off, ln,
                                                device="cpu")


def test_failed_recover_reaps_its_stage_files(tmp_path):
    """A recover that fails after staging leaves no .codeword.stage: all
    block files CRC-corrupt (the stat scan passes, the staging read
    fails), then all gone; and a striped recover whose middle stripe is
    unrecoverable reaps the prefetch pipeline's stages."""
    src = _payload(tmp_path / "u.bin", 4 * 4096, 41)
    out = tmp_path / "coded"
    storage.encode_file_stream(src, out, GF32, device="cpu")
    for f in _block_files(out):
        blob = bytearray(f.read_bytes())
        blob[0] ^= 0xFF
        f.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="valid survivors"):
        storage.recover_file_stream(out, tmp_path / "x.bin", device="cpu")
    assert not (out / ".codeword.stage").exists()
    for f in _block_files(out):
        f.unlink()
    with pytest.raises(ValueError, match="unrecoverable"):
        storage.recover_file_stream(out, tmp_path / "y.bin", device="cpu")
    assert not (out / ".codeword.stage").exists()

    src = _payload(tmp_path / "f.bin", 11 * 4096, 42)
    out = tmp_path / "striped"
    man = storage.encode_file(src, out, GF32, stripe_blocks=4, device="cpu")
    st = man["stripes"][1]
    for f in _block_files(out / "stripe_0001")[: st["n"] - st["k"] + 1]:
        f.unlink()
    with pytest.raises(ValueError, match="unrecoverable"):
        storage.recover_file(out, tmp_path / "f.back", chunk_lanes=64,
                             device="cpu")
    assert not list(out.rglob(".codeword.stage"))


@pytest.mark.parametrize("field", [GF32, GF16], **FIELD_IDS)
def test_repair_with_check_matches_reference(tmp_path, field):
    """Streamed repair with the audit on: two data files gone and a
    parity block silently changed with its CRC forged; both packages
    rewrite the same files and re-tag the same manifest."""
    _encode_both(tmp_path, field, 9 * 4096 + 11, 51)
    man = json.loads((tmp_path / "port" / "manifest.json").read_text())
    victim = sorted((tmp_path / "port").glob("block_*.par"))[1]
    blob = bytearray(victim.read_bytes())
    blob[1000] ^= 0x3C
    man["crc32c"][victim.stem.split("_")[1].lstrip("0")] = int(
        host.crc32c(bytes(blob)))

    def damage(d):
        for f in sorted(d.glob("block_*.dat"))[:2]:
            f.unlink()
        (d / victim.name).write_bytes(bytes(blob))
        (d / "manifest.json").write_text(json.dumps(man))
    _both(tmp_path, damage)
    wrote = storage.recover_file(tmp_path / "port", None, chunk_lanes=64,
                                 repair=True, check=True, device="cpu")
    assert wrote == jstorage.recover_file(tmp_path / "ref", None,
                                          chunk_lanes=64, repair=True,
                                          check=True)
    _assert_same_tree(tmp_path / "ref", tmp_path / "port")
    assert storage.check_file(tmp_path / "port",
                              device="cpu")[0]["status"] == "healthy"


def test_manifest_numbers_are_python_ints(tmp_path):
    """Every number the port writes into a manifest is a Python int (the
    JSON text is the reference's, and no tensor or numpy scalar leaks)."""
    src = _payload(tmp_path / "m.bin", 3 * 4096 + 1, 61)
    man = storage.encode_file(src, tmp_path / "d", GF32, stripe_blocks=2,
                              device="cpu")

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
        else:
            assert x is None or type(x) in (int, str, bool), type(x)
    walk(man)
    for st in man["stripes"]:
        walk(json.loads((tmp_path / "d" / st["dir"] /
                         "manifest.json").read_text()))
    assert os.path.getsize(tmp_path / "d" / "manifest.json") > 0
