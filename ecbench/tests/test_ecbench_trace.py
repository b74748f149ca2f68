"""The trace reduction on a hand-made trace: busy time, idle gaps by
host span, the guard against a trace that lost the call's kernels, and
the readers built on them. CPU only."""

import pytest

from ecbench import bench, ops, run
from ecbench.trace import Trace, short_name

ENTRY = "decode.prepare_decode_tables"


def _trace(kernels=True) -> Trace:
    spans = [("ecbench.window", 0, 1000),
             ("ecbench.call", 100, 500), (ENTRY, 100, 150),
             (ENTRY + ":fence", 150, 300), ("decode.decode_prepared", 300, 320),
             ("decode.decode_prepared:fence", 320, 500),
             ("ecbench.call", 600, 900), (ENTRY, 600, 650),
             (ENTRY + ":fence", 650, 700),
             ("decode.decode_prepared", 700, 710),
             ("decode.decode_prepared:fence", 710, 900)]
    device = [("void (anonymous namespace)::col_kernel<0, 9, true, 1>"
               "(fecc::PassArgs)", "kernel", 120, 200),
              ("at::native::add", "kernel", 210, 290),
              ("Memcpy DtoD", "gpu_memcpy", 280, 300),
              ("void (anonymous namespace)::row_kernel<0, 9>(RowArgs)",
               "kernel", 330, 480),
              ("void (anonymous namespace)::col_kernel<0, 9, true, 1>"
               "(fecc::PassArgs)", "kernel", 620, 690),
              ("void (anonymous namespace)::row_kernel<0, 9>(RowArgs)",
               "kernel", 720, 880)]
    if not kernels:
        device = [d for d in device if d[2] < 500]
    return Trace(spans, device)


def test_busy_and_gaps():
    t = _trace()
    assert t.busy_ns(0, 1000) == 80 + 90 + 150 + 70 + 160
    gaps = dict(t.idle_gaps())
    assert sum(gaps.values()) == pytest.approx((1000 - 550) / 1e9)
    assert gaps["ecbench.loop"] == pytest.approx((120 + 140 + 120) / 1e9)
    assert gaps["decode.decode_prepared"] == pytest.approx((30 + 30) / 1e9)
    assert gaps[ENTRY + ":fence"] == pytest.approx(10 / 1e9)
    assert ENTRY not in gaps


def test_device_ops():
    t = _trace()
    ops = dict(t.device_ops())
    assert ops["row_kernel<0, 9>"] == pytest.approx(310 / 1e9)
    assert ops["col_kernel<0, 9, true, 1>"] == pytest.approx(150 / 1e9)
    assert short_name("void at::native::add(int)") == "at::native::add"


def test_guard():
    assert _trace().guard() is None
    assert "1 of 2" in _trace(kernels=False).guard()
    assert "no profiled window" in Trace([], []).guard()


def test_readers_on_a_trace():
    cell = bench.cell("gf32_n1m.repair")
    op = ops.make(cell.config, cell.traffic, 1, "cpu")
    r = run.Run(cell, op, 1.0, 1.0, [], _trace())
    idle = bench.reader("device_idle_pct.repair")(r)
    assert idle == pytest.approx(100 * (1 - 550 / 1000))
    # each profiled call is busy (80 + 90 + 150 + 70 + 160) / 2 ns
    least = max(op.least_s().values())
    share = bench.reader("repair_roofline")(r)
    assert share == pytest.approx(100 * least / (275 / 1e9))
    assert bench.reader("enqueue_ms.repair")(r) is None
    r.trace = None
    assert bench.reader("repair_roofline")(r) is None
    assert bench.reader("device_idle_pct.repair")(r) is None
