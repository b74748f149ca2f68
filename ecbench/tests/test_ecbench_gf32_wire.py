"""The raw-byte GF32 cell ``gf32_n1m_wire.encode``: whole runs at a size
the CPU holds come out correct, and the control and faults planted in
the parity's words and in its escape bitmap come out not correct; the
plain reference's wire format on hand-made blocks; the hand counts of
the operation and of the pack; and the pack's readers on a hand-made
trace. CPU only."""

import time

import pytest
import torch

from ecbench import bench, control, ops, peaks, run, spans
from ecbench import trace as tr
from ecbench.reference import gf32_wire as wire
from fastecc_tpu_torch import rs

CELL = "gf32_n1m_wire.encode"
P = 0xFFF00001
SMALL = dict(n=128, k=64, block_bytes=256)
SEED = 2 ** 31 + 29
FULL_BLOCK = ops.REF_BLOCK


def _cell(**small) -> bench.Cell:
    cell = bench.cell(CELL)
    cell.config.update(small)
    return cell


def _run(seed: int = SEED, **small) -> dict:
    return run.run_cell(_cell(**(small or SMALL)), seed, 0.2, False,
                        device="cpu", t_start=time.perf_counter())


def _op(**small):
    cell = _cell(**small)
    return ops.make(cell.config, cell.traffic, 1, "cpu")


@pytest.mark.parametrize("ref_block", [FULL_BLOCK, 64 * 32])
def test_sound_run_is_correct(ref_block, monkeypatch):
    # the small reference block judges the 64 words in two blocks of 32,
    # each with its two bitmap lanes
    monkeypatch.setattr(ops, "REF_BLOCK", ref_block)
    assert len(ops.lane_blocks(64, 64, align=16)) == (
        1 if ref_block == FULL_BLOCK else 2)
    line = _run()
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["checks"]["judged_outputs"]["value"] == 2
    assert set(line["metrics"]) == {"encode_GBps", "encode_p95_ms",
                                    "setup_s"}


def test_control_is_not_correct():
    with control.in_place(bench.cell(CELL).traffic["op"]):
        line = _run()
    assert not line["correct"]
    assert line["checks"]["bad_words"]["value"] > 0


def _word_altered(out, raw):
    out = out.clone()
    out[-1, 5] ^= 1
    return out


def _bitmap_bit_flipped(out, raw):
    # the parity's last bitmap lane, the first of its four bytes
    out = out.clone()
    out[0, -4] ^= 0x10
    return out


def _input_handed_back(out, raw):
    return raw.clone()


@pytest.mark.parametrize("fault", [_word_altered, _bitmap_bit_flipped,
                                   _input_handed_back],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(fault, monkeypatch):
    real = rs.encode_blocks

    def broken(raw, *args, **kwargs):
        return fault(real(raw, *args, **kwargs), raw)
    monkeypatch.setattr(rs, "encode_blocks", broken)
    line = _run()
    assert not line["correct"]
    assert line["failed"] >= 1


def test_every_run_has_all_ff_blocks_and_escaped_words():
    op = _op(**SMALL)
    op.prepare()
    for raw in op.pool:
        ff = (raw == 0xFF).all(dim=1)
        assert int(ff.sum()) == 1          # 64 / 64
        words = wire.gf32_words(raw)
        assert int(words[:, 64:].ne(0).sum()) >= 4   # the 0xFF row's lanes


def test_reference_wire_format_by_hand():
    words = [0, 1, P - 1, P, P + 1, 0xFFFFFFFF, 0xFFF00000, 0x12345678]
    words += [0xFFFFFFFF] * 8 + [P] * 3        # 19 words, 2 bitmap lanes
    raw = torch.tensor([list(w.to_bytes(4, "little")) for w in words],
                       dtype=torch.uint8).reshape(1, -1)
    lanes = wire.gf32_words(raw)
    stored = [w - P if w >= P else w for w in words]
    esc = [int(w >= P) for w in words]
    bits = [sum(e << j for j, e in enumerate(esc[:16])),
            sum(e << j for j, e in enumerate(esc[16:]))]
    assert lanes.tolist() == [stored + bits]
    assert bits == [0xFF38, 0b111]
    back = wire.gf32_wire(lanes)
    assert back.shape == (1, 4 * 21)
    assert bytes(back[0, :4 * 19].tolist()) == b"".join(
        s.to_bytes(4, "little") for s in stored)
    with pytest.raises(ValueError):
        wire.gf32_words(torch.zeros(1, 6, dtype=torch.uint8))


def test_operation_and_pack_bytes_match_the_hand_counts():
    op = _op()
    # 2^19 raw 4 KB blocks read, 2^19 parity blocks of 4352 B written
    assert op.operation_bytes() == 2 ** 19 * 4096 + 2 ** 19 * 4352
    assert op.operation_bytes() == 4_429_185_024
    # the pack reads the same raw blocks and writes 1088 lanes a block
    assert op.pack_bytes() == 2 ** 19 * 4096 + 2 ** 19 * 1088 * 4
    assert op.pack_bytes() == op.operation_bytes()
    t19 = 2 ** 18 * 19 - 2 ** 19 + 1
    assert op.operation_multiplies() == 1088 * (2 * t19 + 2 ** 19)
    assert op.operation_multiplies() == 1088 * ops.encode_multiplies(
        "GF32", 2 ** 20, 2 ** 19)


def test_which_bound_binds():
    least = _op().least_s()
    assert max(least, key=least.get) == "bytes"
    assert 1e3 * least["bytes"] == pytest.approx(1.3221, abs=1e-4)
    assert 1e3 * least["operations"] == pytest.approx(1.2260, abs=1e-4)


def test_op_refuses_other_formats():
    with pytest.raises(ValueError):
        _op(block_bytes=72)
    cell = bench.cell("gf16_n16k.encode")
    with pytest.raises(ValueError):
        ops.module("encode_blocks_gf32").Op(cell.config, bench.cell(
            CELL).traffic, 1, "cpu", None)


def _trace(program=True):
    """Two calls, each an ``rs.encode_blocks`` whose pack span launched
    three ops (busy 200-260 and 270-300: 90 ns) before K1; with
    ``program`` False the parent's program, which opens no pack span."""
    spans_, launches, device = [(tr.WINDOW, 0, 2000)], {}, []
    for t0 in (0, 1000):
        spans_ += [(tr.CALL, t0 + 100, t0 + 900),
                   ("rs.encode_blocks", t0 + 100, t0 + 400),
                   ("fecc.rs.encode_blocks", t0 + 110, t0 + 390)]
        if program:
            spans_.append(("fecc.packing.pack_data", t0 + 120, t0 + 160))
        spans_.append(("fecc.pass.K1_col", t0 + 170, t0 + 180))
        c = t0 // 100
        launches.update({c + 1: t0 + 130, c + 2: t0 + 140, c + 3: t0 + 150,
                         c + 4: t0 + 175})
        device += [("elementwise", "kernel", t0 + 200, t0 + 240, c + 1),
                   ("elementwise", "kernel", t0 + 230, t0 + 260, c + 2),
                   ("cat", "kernel", t0 + 270, t0 + 300, c + 3),
                   ("col_kernel<0,9,1,0>", "kernel", t0 + 300, t0 + 500,
                    c + 4)]
    return spans.SpanTrace(spans_, [d[:4] for d in device], launches,
                           [d[4] for d in device])


def _read(name, trace, op=None):
    return bench.reader(name)(run.Run(bench.cell(CELL), op or _op(), 1.0,
                                      1.0, [], trace))


def test_pack_readers_on_a_hand_made_trace():
    t = _trace()
    assert _read("pack_launches", t) == 3
    assert _read("pack_ms", t) == pytest.approx(90e-6)
    op = _op()
    want = 100 * op.pack_bytes() / peaks.HBM_BYTES_PER_S / 90e-9
    assert _read("pack_roofline", t, op) == pytest.approx(want)


@pytest.mark.parametrize("trace", [None, "parent"])
def test_pack_readers_read_nothing_without_the_span(trace):
    t = _trace(program=False) if trace else None
    for name in ("pack_ms", "pack_launches", "pack_roofline"):
        assert _read(name, t) is None
