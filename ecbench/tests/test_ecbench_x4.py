"""The four-card cell ``gf32_n1m_x4.encode``: its operation's hand counts
at the configuration's size, the readers of the sharded codec's spans
(``exchange_ms``, ``mul_table_ms``, ``mul_table_launches``) on hand-made
traces and on a real CPU profiler session, and a run of the cell's mix on
four CPU ranks over Gloo from a temporary ``BENCHMARK.json`` holding the
cell at a size the CPU holds. CPU only."""

import functools
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ecbench import bench, control, ops, run, spans, world
from ecbench import trace as tr
from ecbench.tests import world_faults as wf
from fastecc_tpu_torch import fields
from fastecc_tpu_torch.parallel import mesh, ntt_dist

CELL = "gf32_n1m_x4.encode"
NEW = ["exchange_ms", "mul_table_ms", "mul_table_launches"]
SEED = 2 ** 33 + 21


def _op():
    cell = bench.cell(CELL)
    w = world.World(0, cell.chips, "unused", 1.0, "unused")
    return ops.make(cell.config, cell.traffic, SEED, "cpu", w)


def test_the_cell_is_the_headline_stripe_on_four_cards():
    cell = bench.cell(CELL)
    assert cell.chips == 4 and cell.traffic["mesh"] == [4, 1]
    c = cell.config
    assert (c["field"], c["p"], c["n"], c["k"], c["block_bytes"]) == (
        "GF32", 0xFFF00001, 2 ** 20, 2 ** 19, 32768)
    assert c["reduced"] == [] and "block_bytes" in c["assumed"]
    assert {m["name"] for m in cell.end_to_end} == {
        "encode_GBps", "encode_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "encode_roofline", "device_idle_pct.encode", *NEW}
    # only this cell reads the new metrics
    for name in ("gf32_n1m.encode", "gf16_n16k.encode", "gf32_n1m.repair"):
        assert not {m["name"] for m in bench.cell(name).per_layer} & set(NEW)


def test_hand_counts_of_a_rank():
    op = _op()
    # a rank reads its 2^18 data blocks and writes its 2^18 parity blocks
    assert op.operation_bytes() == 2 ** 18 * 32768 == 8 * 2 ** 30
    # two transforms, each sending 3/4 of the rank's 2^17 rows of 32 KB
    assert op.link_bytes() == 2 * 3 * 2 ** 17 * 32768 // 4 == 6 * 2 ** 30
    t19 = 2 ** 18 * 19 - 2 ** 19 + 1
    assert op.operation_multiplies() == 8192 * (2 * t19 + 2 ** 19) // 4
    # the whole codeword's bytes a call, which encode_GBps counts
    assert op.codeword_bytes == 2 ** 20 * 32768 == 32 * 2 ** 30
    least = op.least_s()
    assert max(least, key=least.get) == "link"
    assert 1e3 * least["link"] == pytest.approx(14.3165, abs=1e-4)
    assert 1e3 * least["bytes"] == pytest.approx(2.5642, abs=1e-4)


X, M = "fecc.dist.exchange", "fecc.dist.mul_table"
NCCL = "void ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4>(int)"


def _call(t0, program, nccl_launched):
    """One call at ``t0``: the harness's spans, and with ``program`` the
    port's (an entry span around two exchanges, each two spans, and two
    table multiplies, the first with a pass span inside it); the
    launch records and the device operations, correlation ids from
    t0 // 10. The NCCL kernels have launch records where
    ``nccl_launched``."""
    harness = [(tr.CALL, t0 + 10, t0 + 990)]
    mine = [("fecc.dist.encode_parity_sharded", t0 + 20, t0 + 900),
            (X, t0 + 30, t0 + 40), (X, t0 + 100, t0 + 110),
            (M, t0 + 200, t0 + 260), ("fecc.pass.K1_col", t0 + 230, t0 + 240),
            (X, t0 + 300, t0 + 310), (X, t0 + 400, t0 + 410),
            (M, t0 + 500, t0 + 560)]
    c = t0 // 10
    launches = {c + 1: t0 + 32, c + 3: t0 + 105, c + 4: t0 + 210,
                c + 5: t0 + 235, c + 6: t0 + 250, c + 7: t0 + 302,
                c + 9: t0 + 405, c + 10: t0 + 510, c + 11: t0 + 520,
                c + 12: t0 + 600}
    if nccl_launched:
        launches.update({c + 2: t0 + 35, c + 8: t0 + 305})
    device = [
        ("void at::native::elementwise_kernel<128, 4>(int)", "kernel",
         t0 + 40, t0 + 50, c + 1),                       # pack 1
        (NCCL, "kernel", t0 + 50, t0 + 100, c + 2),       # all-to-all 1
        ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", t0 + 110, t0 + 120,
         c + 3),                                          # unpack 1
        (ELEMENTWISE, "kernel", t0 + 215, t0 + 225, c + 4),   # multiply 1
        ("void col_kernel<0, 9, 1, 0>(PassArgs)", "kernel", t0 + 240,
         t0 + 280, c + 5),                                # K1, nested
        (ELEMENTWISE, "kernel", t0 + 280, t0 + 290, c + 6),   # multiply 1
        ("void at::native::elementwise_kernel<128, 4>(int)", "kernel",
         t0 + 310, t0 + 315, c + 7),                      # pack 2
        (NCCL, "kernel", t0 + 315, t0 + 395, c + 8),      # all-to-all 2
        ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", t0 + 410, t0 + 415,
         c + 9),                                          # unpack 2
        (ELEMENTWISE, "kernel", t0 + 515, t0 + 530, c + 10),  # multiply 2
        (ELEMENTWISE, "kernel", t0 + 525, t0 + 540, c + 11),  # multiply 2
        ("void at::native::CatArrayBatchedCopy(int)", "kernel", t0 + 610,
         t0 + 620, c + 12)]                               # the entry's
    return harness + (mine if program else []), launches, device


def _trace(program=True, nccl_launched=True):
    spans_, launches, device = [(tr.WINDOW, 0, 2000)], {}, []
    for t0 in (0, 1000):
        s, ln, d = _call(t0, program, nccl_launched)
        spans_ += s
        launches.update(ln)
        device += d
    return spans.SpanTrace(spans_, [d[:4] for d in device], launches,
                           [d[4] for d in device])


def _read(name, trace):
    cell = bench.cell(CELL)
    r = run.Run(cell, _op(), 1.0, 1.0, [], trace)
    return bench.reader(name)(r)


def test_readers_of_the_sharded_spans():
    t = _trace()
    # each call: packs 40-50 and 310-315, NCCL 50-100 and 315-395, unpacks
    # 110-120 and 410-415: 60 + 10 + 85 + 5 = 160 ns of union
    assert _read("exchange_ms", t) == pytest.approx(160e-6)
    # the multiplies' own ops: 215-225, 280-290, 515-540; K1, launched in
    # its pass span inside the first multiply, is not the multiply's
    assert _read("mul_table_ms", t) == pytest.approx(45e-6)
    assert _read("mul_table_launches", t) == 4
    launched = [t.launcher(t.launches.get(c, -1), t.program(0, 1000))
                for c in t.correlation[:12]]
    assert launched == [X, X, X, M, "fecc.pass.K1_col", M, X, X, X, M, M,
                        "fecc.dist.encode_parity_sharded"]


def test_nccl_kernels_without_launch_records_are_left_out():
    """An op with no launch record has no launching span: the exchange
    reads its packs and unpacks alone (the readers compare no card time
    with the host's)."""
    t = _trace(nccl_launched=False)
    assert _read("exchange_ms", t) == pytest.approx(30e-6)
    assert _read("mul_table_ms", t) == pytest.approx(45e-6)
    assert t.unlaunched() == {"ncclDevKernel_SendRecv": 4}


def test_readers_read_nothing_without_the_program_spans():
    """The parent's program has no ``fecc.dist`` spans: the new readers
    return None, and do not raise, with or without NCCL's records."""
    for nccl_launched in (True, False):
        t = _trace(program=False, nccl_launched=nccl_launched)
        for name in NEW:
            assert _read(name, t) is None
    for name in NEW:
        assert _read(name, None) is None


def test_readers_of_a_real_cpu_session(tmp_path):
    """A sharded encode on a world of one CPU rank under the profiler,
    reduced as the harness holds it: the ``fecc.dist`` spans come through
    (the coset's table multiply; one rank has no exchange); with no card
    nothing was launched, so nothing is read."""
    import torch.distributed as dist
    mesh.init_process_group(0, 1, tmp_path / "store", device="cpu",
                            timeout=60)
    try:
        m = mesh.make_mesh(1, 1)
        data = torch.arange(16 * 4, dtype=torch.int64).to(torch.int32).view(
            torch.uint32).reshape(16, 4)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(tr.WINDOW):
                with record_function(tr.CALL):
                    ntt_dist.encode_parity_sharded(data, fields.GF32, m)
    finally:
        dist.destroy_process_group()
    base = tr.collect(prof, {tr.WINDOW, tr.CALL})
    cell = bench.cell(CELL)
    r = run.Run(cell, _op(), 1.0, 1.0, [], base)
    found = spans.of(r)
    assert isinstance(found, spans.SpanTrace)
    names = [n for n, _, _ in sorted(found.program(*found.window()),
                                     key=lambda s: s[1])]
    assert names[:2] == ["fecc.dist.encode_parity_sharded",
                         "fecc.dist.ntt_sharded"]
    assert names.count(M) == 1 and X not in names
    for name in NEW:
        assert bench.reader(name)(r) is None


def _spec(tmp):
    """A ``BENCHMARK.json`` holding the cell alone, its configuration cut
    to 2^10 blocks of 64 bytes, its metrics the real entries."""
    real = json.loads(bench.BENCHMARK.read_text())
    conf = dict(bench.cell(CELL).config, n=1 << 10, k=1 << 9,
                block_bytes=64, reduced=["n", "k", "block_bytes"])
    path = tmp / "gf32_n1m_x4.json"
    path.write_text(json.dumps(conf))
    entry = {c["name"]: c for c in real["configs"]}["gf32_n1m_x4"]
    spec = dict(real,
                configs=[dict(entry, file=str(path), reduced=conf["reduced"])],
                workloads=[w for w in real["workloads"] if w["name"] == CELL],
                end_to_end=[m for m in real["end_to_end"]
                            if bench.reports(m, CELL)],
                per_layer=[m for m in real["per_layer"]
                           if bench.reports(m, CELL)])
    out = tmp / "BENCHMARK.json"
    out.write_text(json.dumps(spec))
    return out


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return bench.cell(CELL, _spec(tmp_path_factory.mktemp("x4")))


def test_the_cell_runs_correct_on_four_cpu_ranks(small):
    line = run.run_cell(small, SEED, 0.5, False, device="cpu",
                        t_start=time.perf_counter(),
                        rank_init=functools.partial(wf.plant, None, 0))
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"]["judged_outputs"]["value"] == 2
    assert line["device"]["count"] == 4
    assert set(line["metrics"]) == {"encode_GBps", "encode_p95_ms",
                                    "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("fault", ["control", "altered"])
def test_the_control_and_a_fault_are_not_correct(small, fault):
    """The control in every rank's place (``ecbench.control``), or one
    word of rank 2's parity changed where it is produced."""
    if fault == "control":
        line = control.run_cell(small, SEED, 0.5, device="cpu",
                                rank_init=functools.partial(wf.plant, None,
                                                            0))
    else:
        line = run.run_cell(small, SEED, 0.5, False, device="cpu",
                            t_start=time.perf_counter(),
                            rank_init=functools.partial(wf.plant, fault, 2))
    assert not line["correct"]
    assert line["checks"]["bad_words"]["value"] > 0
