"""Port vs reference: the CLI (fastecc_tpu_torch.cli vs fastecc_tpu.cli).

Under ``--device cpu`` the codec commands print the reference's lines
and JSON keys (plus ``device``), and the file commands write the
reference's bytes and return its exit codes on the scenarios of
tests/test_cli.py; ``--seam off`` takes the staged route and gives the
pair's bits; without a GPU every command raises unless ``--device cpu``.
"""

import json
import re

import numpy as np
import pytest
import torch

from fastecc_tpu import cli as jcli
from fastecc_tpu_torch import cli, decode, fields, rs
from fastecc_tpu_torch.interop import to_numpy_u32
from fastecc_tpu_torch.kernels import ntt_mfa

torch.set_num_threads(1)

# keys whose values are timings (or rates from them)
TIMED = {"seconds", "gb_per_sec", "parity_gb_per_sec",
         "recovered_gb_per_sec", "locator_build_seconds"}


def _json_lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


class Both:
    """Runs each command through both CLIs, the reference on ``ref/`` and
    the port (``--device cpu``) on ``port/``, and holds them to the same
    exit code, the same text lines and the same JSON plus ``device``."""

    def __init__(self, tmp_path, capsys):
        self.root, self.capsys = tmp_path, capsys
        for side in ("ref", "port"):
            (tmp_path / side).mkdir()

    def __call__(self, *argv, timed=False):
        res = {}
        for side, main, pre in (("ref", jcli.main, []),
                                ("port", cli.main, ["--device", "cpu"])):
            d = self.root / side
            rc = main(pre + [a.format(d=d) for a in argv])
            out = self.capsys.readouterr().out.replace(str(d), "{d}")
            res[side] = (rc, out)
        (jrc, jout), (rc, out) = res["ref"], res["port"]
        assert rc == jrc, (argv, res)
        text = [ln for ln in out.splitlines() if not ln.startswith("{")]
        assert text == [ln for ln in jout.splitlines()
                        if not ln.startswith("{")]
        for got, want in zip(_json_lines(out), _json_lines(jout),
                             strict=True):
            assert got.pop("device") == "cpu"
            assert set(got) == set(want)
            if timed:
                got = {k: v for k, v in got.items() if k not in TIMED}
                want = {k: v for k, v in want.items() if k not in TIMED}
            assert got == want
        return rc, out

    def each(self, fn):
        for side in ("ref", "port"):
            fn(self.root / side)

    def trees_equal(self):
        def tree(d):
            return {str(p.relative_to(d)): p.read_bytes()
                    for p in sorted(d.rglob("*")) if p.is_file()}
        a, b = tree(self.root / "ref"), tree(self.root / "port")
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name] == b[name], name


@pytest.fixture
def both(tmp_path, capsys):
    return Both(tmp_path, capsys)


def _write(both, name: str, payload: bytes):
    both.each(lambda d: (d / name).write_bytes(payload))


def test_codec_commands_print_the_reference_lines(both):
    """verify and roundtrip print the reference's lines; ntt-bench,
    rs-bench and decode-bench its JSON keys and untimed values, plus
    device. (--algo pallas and --seam on launch TPU kernels in the
    reference, so the port runs them alone.)"""
    both("verify", "--lg-n", "6")
    both("--field", "gf16", "verify", "--lg-n", "5")
    both("roundtrip", "--lg-n", "8")
    for algo in ("auto", "stockham", "fourstep"):
        both("ntt-bench", "--lg-n", "6", "--lanes", "4", "--iters", "1",
             "--algo", algo, timed=True)
    both("ntt-bench", "--lg-n", "6", "--lanes", "4", "--iters", "1",
         "--inverse", "--radix", "2", "--algo", "stockham", timed=True)
    for seam in ("auto", "off"):
        both("rs-bench", "--lg-k", "5", "--lanes", "8", "--iters", "1",
             "--seam", seam, timed=True)
    both("--field", "gf16", "rs-bench", "--lg-k", "5", "--lanes", "8",
         "--iters", "1", timed=True)
    _, out = both("decode-bench", "--lg-n", "6", "--lg-e", "5", "--lanes",
                  "8", "--iters", "1", timed=True)
    assert _json_lines(out)[0]["recovered_ok"] is True
    both("decode-bench", "--lg-n", "6", "--lg-e", "5", "--lanes", "8",
         "--iters", "1", "--seam", "off", "--device-locator", timed=True)
    for argv in (["ntt-bench", "--lg-n", "6", "--lanes", "4", "--algo",
                  "pallas"], ["rs-bench", "--lg-k", "5", "--lanes", "8",
                              "--seam", "on"]):
        assert cli.main(["--device", "cpu", *argv, "--iters", "1"]) == 0
        line = _json_lines(both.capsys.readouterr().out)[0]
        assert line["device"] == "cpu"


def test_pair_c_dim_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "rs-bench", "--pair-c-dim", "8"])
    assert e.value.code == 2
    assert "--pair-c-dim has no counterpart" in capsys.readouterr().err


@pytest.fixture
def routes(monkeypatch):
    """Counts of the pair entries and the single transform."""
    calls = {"ntt_pair": 0, "ntt_coset_pair": 0, "ntt_fused": 0,
             "ntt_coset_pair_wire16": 0}
    for name in calls:
        real = getattr(ntt_mfa, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ntt_mfa, name, spy)
    return calls


@pytest.mark.parametrize("field", [fields.GF32, fields.GF16],
                         ids=lambda f: f.name)
def test_seam_off_takes_the_staged_route_with_the_same_bits(routes, field):
    """With the pair switch off (cli's _seam_dispatch("off"), what
    --seam off sets) the encode, the prepared decode, the parity-only
    decode and the GF16 wire encode run two staged transforms, never a
    pair, and give the pair route's bits; the switch is restored after."""
    rng = np.random.default_rng(0x5EA)
    k, lanes = 32, 12
    data = rng.integers(0, field.p, (k, lanes), dtype=np.uint64).astype(
        np.uint32)
    raw = torch.from_numpy(rng.integers(0, 256, (16, 64), dtype=np.uint16)
                           .astype(np.uint8))
    erased = np.sort(rng.choice(2 * k, k // 2, replace=False))

    def run():
        par = rs.encode_parity(data, field, device="cpu")
        cw = rs.encode(data, field, device="cpu")
        tables = decode.prepare_decode_tables(erased, 2 * k, field,
                                              device="cpu")
        dec = decode.decode_prepared(cw, *tables, field)
        raw_dec = decode.decode_prepared(cw, *tables, field, merge=False)
        back = decode.decode_data_from_parity(par, field, 2 * k)
        wire = rs.encode_blocks(raw, field)
        return [to_numpy_u32(t) for t in (par, dec, raw_dec, back)] + [
            wire.numpy()]

    on = run()
    assert routes["ntt_pair"] and routes["ntt_coset_pair"]
    if not field.use_mont:
        assert routes["ntt_coset_pair_wire16"] == 1
    for name in routes:
        routes[name] = 0
    with cli._seam_dispatch("off"):
        assert ntt_mfa._pair_supported(2 * k) is False
        off = run()
    assert ntt_mfa.PAIR_ENABLED is True
    assert routes["ntt_pair"] == routes["ntt_coset_pair"] == 0
    assert routes["ntt_coset_pair_wire16"] == 0
    assert routes["ntt_fused"] >= 8
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def test_rs_bench_seam_off_dispatch(routes, capsys):
    assert cli.main(["--device", "cpu", "rs-bench", "--lg-k", "5",
                     "--lanes", "8", "--iters", "1", "--seam", "off"]) == 0
    assert routes["ntt_coset_pair"] == 0 and routes["ntt_fused"] > 0
    assert cli.main(["--device", "cpu", "rs-bench", "--lg-k", "5",
                     "--lanes", "8", "--iters", "1"]) == 0
    assert routes["ntt_coset_pair"] > 0
    lines = _json_lines(capsys.readouterr().out)
    assert [ln["seam"] for ln in lines] == ["off", "auto"]


def _payload(size: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size, dtype=np.uint16).astype(
        np.uint8).tobytes()


def test_encode_recover_bytes_and_lines(both):
    """tests/test_cli.py:21: encode, lose half the blocks, recover; and
    --block-bytes 512 (:55)."""
    payload = _payload(50000, 9)
    _write(both, "s.bin", payload)
    both("encode", "{d}/s.bin", "-o", "{d}/coded")
    both.trees_equal()
    victims = sorted(p.name for p in (both.root / "port" / "coded")
                     .glob("block_*"))[::2]
    both.each(lambda d: [(d / "coded" / v).unlink() for v in victims])
    both("recover", "{d}/coded", "-o", "{d}/back.bin")
    both.trees_equal()
    assert (both.root / "port" / "back.bin").read_bytes() == payload
    both("encode", "{d}/s.bin", "-o", "{d}/c512", "--block-bytes", "512")
    both("recover", "{d}/c512", "-o", "{d}/back512.bin")
    both.trees_equal()


def test_recover_insufficient_raises(tmp_path):
    """Fewer than k survivors: the port raises ValueError where the
    reference asserts (both exit 1 as a command)."""
    (tmp_path / "s.bin").write_bytes(b"\x55" * 9000)
    coded = tmp_path / "coded"
    assert cli.main(["--device", "cpu", "encode", str(tmp_path / "s.bin"),
                     "-o", str(coded)]) == 0
    blocks = sorted(coded.glob("block_*"))
    for victim in blocks[: len(blocks) - 3]:
        victim.unlink()
    with pytest.raises(ValueError, match="unrecoverable"):
        cli.main(["--device", "cpu", "recover", str(coded), "-o",
                  str(tmp_path / "r.bin")])


def test_repair_and_check_states(both):
    """:74 and :121: check healthy (0), a parity block corrupted under its
    CRC (1), repair, healthy again; then half the blocks lost, repair
    regenerates every file bit for bit."""
    payload = _payload(5000, 11)
    _write(both, "s.bin", payload)
    both("encode", "{d}/s.bin", "-o", "{d}/coded")
    assert both("check", "{d}/coded")[0] == 0
    victim = sorted((both.root / "port" / "coded").glob("block_*.par"))[0]
    blob = bytearray(victim.read_bytes())
    blob[100] ^= 0xFF
    both.each(lambda d: (d / "coded" / victim.name).write_bytes(bytes(blob)))
    assert both("check", "{d}/coded")[0] == 1
    both("repair", "{d}/coded")
    assert both("check", "{d}/coded")[0] == 0
    both.trees_equal()
    names = sorted(p.name for p in (both.root / "port" / "coded")
                   .glob("block_*"))
    both.each(lambda d: [(d / "coded" / v).unlink()
                         for v in names[: len(names) // 2]])
    assert both("check", "{d}/coded")[0] == 1
    both("repair", "{d}/coded")
    both.trees_equal()
    assert both("check", "{d}/coded")[0] == 0


def _forge(d, name: str, blob: bytes):
    from fastecc_tpu_torch import host
    (d / name).write_bytes(blob)
    man = json.loads((d / "manifest.json").read_text())
    man["crc32c"][str(int(re.findall(r"\d+", name)[0]))] = int(
        host.crc32c(blob))
    (d / "manifest.json").write_text(json.dumps(man))


def test_forged_crc_located_and_repaired(both):
    """:184 and :236: a block changed with its CRC forged (check locates
    it, corrupt-located, rc 1; repair fixes and re-tags), then two files
    gone besides a forged survivor (errors and erasures)."""
    _write(both, "s.bin", bytes(range(256)) * 48)
    both("encode", "{d}/s.bin", "-o", "{d}/coded")
    coded = both.root / "port" / "coded"
    victim = sorted(coded.glob("block_*.par"))[0]
    good = victim.read_bytes()
    bad = bytearray(good)
    bad[12] ^= 0x55
    both.each(lambda d: _forge(d / "coded", victim.name, bytes(bad)))
    rc, out = both("check", "{d}/coded")
    rep = _json_lines(out)[0]
    assert (rc, rep["status"]) == (1, "corrupt-located")
    both("repair", "{d}/coded")
    assert victim.read_bytes() == good
    both.trees_equal()
    gone = [p.name for p in sorted(coded.glob("block_*.dat"))[:2]]
    v2 = sorted(coded.glob("block_*.par"))[1]
    bad2 = bytearray(v2.read_bytes())
    bad2[33] ^= 0x1F

    def damage(d):
        for g in gone:
            (d / "coded" / g).unlink()
        _forge(d / "coded", v2.name, bytes(bad2))
    both.each(damage)
    both("repair", "{d}/coded")
    both.trees_equal()
    assert both("check", "{d}/coded")[0] == 0


def test_recover_check_corrects_a_lying_survivor(both):
    """:269: recover --check writes the source despite a forged data
    survivor and a lost parity file, in core and streamed."""
    payload = bytes(range(256)) * 40
    _write(both, "s.bin", payload)
    both("--field", "gf16", "encode", "{d}/s.bin", "-o", "{d}/coded")
    coded = both.root / "port" / "coded"
    victim = sorted(coded.glob("block_*.dat"))[1]
    bad = bytearray(victim.read_bytes())
    bad[100] ^= 0x77
    lost = sorted(coded.glob("block_*.par"))[0].name

    def damage(d):
        _forge(d / "coded", victim.name, bytes(bad))
        (d / "coded" / lost).unlink()
    both.each(damage)
    for extra in ([], ["--max-resident", "0"]):
        both("recover", "{d}/coded", "-o", "{d}/back.bin", "--check",
             *extra)
        assert (both.root / "port" / "back.bin").read_bytes() == payload
    both.trees_equal()


def test_update_and_read(both):
    """:346 and :373: update splices an edit (the directory stays the
    reference's), recover after losing every data block returns the
    edited payload, and read serves a range from the degraded
    directory."""
    payload = bytearray(_payload(3 * 4096 + 99, 0xED17))
    _write(both, "doc.bin", bytes(payload))
    both("encode", "{d}/doc.bin", "-o", "{d}/coded")
    edit = b"the new contents of the middle of the document"
    off = 4096 + 17
    payload[off: off + len(edit)] = edit
    _write(both, "patch.bin", edit)
    both("update", "{d}/coded", "{d}/patch.bin", "--offset", str(off))
    both.trees_equal()
    both.each(lambda d: [f.unlink() for f in (d / "coded").glob(
        "block_*.dat")])
    both("recover", "{d}/coded", "-o", "{d}/back.bin")
    assert (both.root / "port" / "back.bin").read_bytes() == bytes(payload)
    both("read", "{d}/coded", "--offset", "4000", "--length", "500", "-o",
         "{d}/range.bin")
    assert (both.root / "port" / "range.bin").read_bytes() == \
        payload[4000:4500]
    both.trees_equal()


def test_streamed_file_commands_match_in_core(both):
    """--max-resident 0 sends encode, recover and check through storage:
    the reference's bytes and lines, and the in-core directory."""
    payload = _payload(7 * 4096 + 5, 77)
    _write(both, "s.bin", payload)
    both("--field", "gf16", "encode", "{d}/s.bin", "-o", "{d}/incore")
    both("--field", "gf16", "encode", "{d}/s.bin", "-o", "{d}/streamed",
         "--max-resident", "0")
    both.trees_equal()
    d = both.root / "port"
    assert sorted(p.name for p in (d / "incore").iterdir()) == sorted(
        p.name for p in (d / "streamed").iterdir())
    for p in (d / "incore").iterdir():
        if p.name == "manifest.json":     # the tags' key order differs
            assert json.loads(p.read_text()) == json.loads(
                (d / "streamed" / p.name).read_text())
        else:
            assert p.read_bytes() == (d / "streamed" / p.name).read_bytes()
    both.each(lambda d: [f.unlink() for f in (d / "streamed").glob(
        "block_*.par")])
    both("recover", "{d}/streamed", "-o", "{d}/back.bin",
         "--max-resident", "0")
    assert (d / "back.bin").read_bytes() == payload
    assert both("check", "{d}/streamed", "--max-resident", "0")[0] == 1


SCALING_KEYS = {"devices", "lanes", "seconds", "gb_per_sec",
                "weak_scaling_eff", "virtual"}


@pytest.mark.parametrize("op", ["encode", "decode", "ntt", "ntt-overlap"])
def test_scaling_sweep_rows(op, capsys):
    """scaling on worlds of 1, 2 and 4 CPU ranks (Gloo): a row per world
    with the reference's keys plus backend and device, every row virtual,
    the first at efficiency 1.0, every rate above 0 (6 significant
    digits, so a toy row never reads 0.0)."""
    assert cli.main(["--device", "cpu", "scaling", "--op", op, "--devices",
                     "4", "--lg-k", "6", "--lanes", "8", "--iters", "1"]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert [r["lanes"] for r in rows] == [8, 16, 32]
    assert all(set(r) == SCALING_KEYS | {"backend", "device"} for r in rows)
    assert all(r["virtual"] and r["backend"] == "gloo"
               and r["device"] == "cpu" for r in rows)
    assert rows[0]["weak_scaling_eff"] == 1.0
    assert all(r["gb_per_sec"] > 0 for r in rows)


def test_scaling_keys_are_the_references(capsys):
    assert jcli.main(["scaling", "--op", "ntt", "--devices", "2", "--lg-k",
                      "5", "--lanes", "4", "--iters", "1"]) == 0
    assert all(set(r) == SCALING_KEYS
               for r in _json_lines(capsys.readouterr().out))


def test_scaling_procs_row_and_baseline(tmp_path, capsys):
    """--procs 4: one structural row over a 2x2 Gloo mesh, every shard
    equal to the single-device port, 3/4/4 exchanges, the reference's
    keys plus device; --update-baseline appends one line to the given
    --baseline-path and writes nothing else (the repo's BASELINE.md
    stays as it was)."""
    import hashlib
    import pathlib
    repo_baseline = pathlib.Path(__file__).resolve().parent.parent / \
        "BASELINE.md"
    before = hashlib.sha256(repo_baseline.read_bytes()).hexdigest()
    path = tmp_path / "BASELINE.md"
    path.write_text("# BASELINE\n\nearlier text\n")
    assert cli.main(["--device", "cpu", "scaling", "--procs", "4",
                     "--update-baseline", "--baseline-path", str(path)]) == 0
    (row,) = _json_lines(capsys.readouterr().out)
    assert set(row) == {"phases", "all_to_all", "bit_exact",
                        "process_count", "devices", "virtual", "transport",
                        "mesh", "field", "lg_n", "device"}
    assert row["bit_exact"] is True
    assert row["all_to_all"] == {"ntt": 3, "encode": 4, "decode": 4}
    assert (row["mesh"], row["transport"], row["process_count"],
            row["lg_n"], row["virtual"]) == ("2x2", "gloo", 4, 10, True)
    assert all(v > 0 for v in row["phases"].values())
    text = path.read_text()
    assert text.startswith("# BASELINE\n\nearlier text\n")
    assert text.count("Multihost structural proxies") == 1
    assert text.rstrip().splitlines()[-1].startswith("- ")
    assert "4-process 2x2 gloo mesh on cpu" in text
    assert sorted(p.name for p in tmp_path.iterdir()) == ["BASELINE.md"]
    assert hashlib.sha256(repo_baseline.read_bytes()).hexdigest() == before


COMMANDS = {
    "verify": ["verify", "--lg-n", "4"],
    "roundtrip": ["roundtrip", "--lg-n", "4"],
    "gf-bench": ["gf-bench", "--lg-size", "4"],
    "ntt-bench": ["ntt-bench", "--lg-n", "4", "--lanes", "4"],
    "rs-bench": ["rs-bench", "--lg-k", "4", "--lanes", "4"],
    "decode-bench": ["decode-bench", "--lg-n", "4", "--lg-e", "2"],
    "roofline": ["roofline"],
    "encode": ["encode", "{d}/s.bin", "-o", "{d}/coded"],
    "recover": ["recover", "{d}/coded", "-o", "{d}/back.bin"],
    "check": ["check", "{d}/coded"],
    "repair": ["repair", "{d}/coded"],
    "read": ["read", "{d}/coded", "--offset", "0", "--length", "1"],
    "update": ["update", "{d}/coded", "{d}/s.bin", "--offset", "0"],
    "scaling": ["scaling", "--devices", "2", "--lg-k", "4"],
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_commands_raise_without_a_card(tmp_path, name):
    """Without a GPU and without --device cpu every command raises before
    it touches a file."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the command would run there")
    (tmp_path / "s.bin").write_bytes(b"x" * 100)
    assert cli.main(["--device", "cpu", "encode", str(tmp_path / "s.bin"),
                     "-o", str(tmp_path / "coded")]) == 0
    before = sorted(p.name for p in tmp_path.rglob("*"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([a.format(d=tmp_path) for a in COMMANDS[name]])
    assert sorted(p.name for p in tmp_path.rglob("*")) == before
