"""The program's spans (``ecbench.spans``): the four readers on a
hand-made trace with ``fecc.`` spans, launch records and correlation ids;
the harness's readers unchanged by them; and the reduction of a real CPU
profiler session of a tiny encode, found from the stack as the harness's
run holds it. CPU only."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ecbench import bench, ops, run, spans
from ecbench import trace as tr
from ecbench.trace import Trace
from fastecc_tpu_torch import rs
from fastecc_tpu_torch.fields import GF32

HARNESS = ["device_idle_pct.wire_encode", "wire_encode_roofline",
           "device_idle_pct.repair", "repair_roofline", "enqueue_ms.encode"]
NEW = ["first_kernel_ms.encode", "first_kernel_ms.repair", "wire_join_ms",
       "wire_join_launches"]


def _call(t0, entry, program):
    """One call at ``t0``: the harness's spans, and with ``program`` the
    port's; its launch records and device operations (a GF16 wire encode:
    K8, K9, K10's fill and kernel, three join ops and one op with no
    launch record), correlation ids from t0."""
    harness = [(tr.CALL, t0 + 100, t0 + 900), (entry, t0 + 100, t0 + 400),
               (entry + ":fence", t0 + 400, t0 + 900)]
    mine = [("fecc." + entry, t0 + 110, t0 + 390),
            ("fecc.pass.K8_col_wire16", t0 + 120, t0 + 160),
            ("fecc.pass.K9_seam_wire16", t0 + 160, t0 + 200),
            ("fecc.pass.K10_row_wire16", t0 + 200, t0 + 240),
            ("fecc.rs.wire_join", t0 + 250, t0 + 380)]
    if not entry.startswith("rs."):
        mine = mine[:-1]          # a decode has no wire join
    c = t0 // 100
    launches = {c + 1: t0 + 150, c + 2: t0 + 190, c + 3: t0 + 230,
                c + 4: t0 + 235, c + 5: t0 + 260, c + 6: t0 + 300,
                c + 7: t0 + 350}
    device = [("void col_kernel<1, 6, 1, 5>(PassArgs)", "kernel", t0 + 170,
               t0 + 300, c + 1),
              ("void col_kernel<1, 7, 1, 1>(PassArgs)", "kernel", t0 + 300,
               t0 + 500, c + 2),
              ("Memset (Device)", "gpu_memset", t0 + 500, t0 + 505, c + 3),
              ("void row_wire16_kernel<6>(RowArgs)", "kernel", t0 + 505,
               t0 + 600, c + 4),
              ("void at::native::vectorized_elementwise_kernel<4>(int)",
               "kernel", t0 + 600, t0 + 620, c + 5),
              ("void at::native::vectorized_elementwise_kernel<4>(int)",
               "kernel", t0 + 615, t0 + 640, c + 6),
              ("void at::native::CatArrayBatchedCopy(int)", "kernel",
               t0 + 650, t0 + 700, c + 7),
              ("void lost_kernel(int)", "kernel", t0 + 700, t0 + 710, 0)]
    return harness + (mine if program else []), launches, device


def _trace(entry="rs.encode_blocks", program=True):
    spans_, launches, device = [(tr.WINDOW, 0, 2000)], {}, []
    for t0 in (0, 1000):
        s, ln, d = _call(t0, entry, program)
        spans_ += s
        launches.update(ln)
        device += d
    ops4 = [d[:4] for d in device]
    if not program:
        return Trace(spans_, ops4)
    return spans.SpanTrace(spans_, ops4, launches, [d[4] for d in device])


def _run(trace, cell="gf16_n16k.encode"):
    c = bench.cell(cell)
    return run.Run(c, ops.make(c.config, c.traffic, 1, "cpu"), 1.0, 1.0, [],
                   trace)


def _read(name, r):
    return bench.reader(name)(r)


def test_readers_of_the_program_spans():
    r = _run(_trace())
    # K8's launch (at 150) after the entry span's start (110)
    assert _read("first_kernel_ms.encode", r) == pytest.approx(40e-6)
    assert _read("first_kernel_ms.repair", r) is None
    # three join ops a call, busy 600-640 and 650-700
    assert _read("wire_join_launches", r) == 3
    assert _read("wire_join_ms", r) == pytest.approx(90e-6)
    t = r.trace
    # K10's fill and kernel were launched in its pass span
    launched = [t.launcher(t.launches.get(c, -1), t.program(0, 1000))
                for c in t.correlation[:8]]
    assert launched == ["fecc.pass.K8_col_wire16", "fecc.pass.K9_seam_wire16",
                        "fecc.pass.K10_row_wire16", "fecc.pass.K10_row_wire16",
                        "fecc.rs.wire_join", "fecc.rs.wire_join",
                        "fecc.rs.wire_join", None]
    assert t.unlaunched() == {"lost_kernel": 2}


def test_first_kernel_of_the_decode_entry():
    r = _run(_trace("decode.decode_prepared"), "gf32_n1m.repair")
    assert _read("first_kernel_ms.repair", r) == pytest.approx(40e-6)
    assert _read("first_kernel_ms.encode", r) is None


def test_harness_readers_unchanged_by_the_program_spans():
    plain, mine = _trace(program=False), _trace()
    for cell in ("gf16_n16k.encode", "gf32_n1m.repair"):
        for name in HARNESS:
            assert _read(name, _run(mine, cell)) == _read(name,
                                                          _run(plain, cell))
    assert plain.calls() == mine.calls()
    assert plain.device_ops() == mine.device_ops()
    assert plain.busy_ns(0, 2000) == mine.busy_ns(0, 2000)
    # a trace without the program's spans (the parent's program) reads
    # nothing for the new metrics
    for name in NEW:
        assert _read(name, _run(plain)) is None
    assert _read("wire_join_ms", _run(None)) is None


def test_a_call_with_the_join_span_but_no_launch_records():
    full = _trace()
    t = spans.SpanTrace(full.spans, full.device, {}, full.correlation)
    r = _run(t)
    assert _read("wire_join_ms", r) is None
    assert _read("wire_join_launches", r) is None
    assert sum(t.unlaunched().values()) == 16
    assert _read("first_kernel_ms.encode", r) is None


def test_collect_finds_and_keeps_the_program_spans():
    data = torch.arange(16 * 4, dtype=torch.int64).to(torch.int32).view(
        torch.uint32).reshape(16, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tr.WINDOW):
            with record_function(tr.CALL):
                rs.encode_parity(data, GF32)
    base = tr.collect(prof, {tr.WINDOW, tr.CALL})
    assert not any(n.startswith("fecc.") for n, _, _ in base.spans)
    found = spans.of(_run(base, "gf32_n1m.encode"))
    assert isinstance(found, spans.SpanTrace)
    assert found.window() == base.window() and found.calls() == base.calls()
    assert [n for n, _, _ in sorted(found.program(*found.window()),
                                    key=lambda s: s[1])] == [
        "fecc.rs.encode_parity", "fecc.pass.K1_col", "fecc.pass.K2_seam",
        "fecc.pass.K3_row"]
    # no card: nothing launched, so nothing to read
    assert found.device == [] and found.first_launch_ms("fecc.rs.") is None
