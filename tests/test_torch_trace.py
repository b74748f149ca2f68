"""The port's spans (``fecc.*``): off, they open no profiler range;
under ``torch.profiler`` each entry's span holds its passes' spans in
order; and the outputs are the same bits with the profiler on and off.
CPU only: the wrappers run their plain versions inside the same spans the
card's launches run in."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fastecc_tpu_torch import decode, rs
from fastecc_tpu_torch.fields import GF16, GF32
from fastecc_tpu_torch.interop import from_numpy_u32
from fastecc_tpu_torch.kernels import ntt_mfa
from fastecc_tpu_torch.utils import profiling

RNG = np.random.default_rng(0x7ACE)


def _words(field, k, lanes):
    high = min(field.p, 1 << 32)
    return from_numpy_u32(RNG.integers(0, high, (k, lanes), dtype=np.uint64)
                          .astype(np.uint32), "cpu")


def _bytes(k, block_bytes):
    return torch.from_numpy(RNG.integers(0, 256, (k, block_bytes),
                                         dtype=np.uint8))


def _repair(merge):
    n, lanes = 32, 4
    cw = rs.encode(_words(GF32, n // 2, lanes), GF32, n)
    lost = RNG.choice(n, n // 2, replace=False)
    tables = decode.prepare_decode_tables(lost, n, GF32, device="cpu")
    return lambda: decode.decode_prepared(cw, *tables, GF32, merge=merge)


def P(key):
    return ("fecc.pass." + key, [])


ENC32 = "fecc.rs.encode_parity"
BLOCKS = "fecc.rs.encode_blocks"
DEC = "fecc.decode.decode_prepared"
JOIN = ("fecc.rs.wire_join", [])
PAIR = [P("K1_col"), P("K2_seam"), P("K3_row")]
STAGED = [P("K1_col"), P("K3_row"), P("K4_col_pre"), P("K3_row")]

# name: (switches set for the case, the call's maker, the span tree)
CASES = {
    "encode_gf32": ({}, lambda: lambda d=_words(GF32, 16, 8):
                    rs.encode_parity(d, GF32), [(ENC32, PAIR)]),
    "encode_gf16": ({}, lambda: lambda d=_words(GF16, 16, 8):
                    rs.encode_parity(d, GF16), [(ENC32, PAIR)]),
    "encode_rate_quarter": ({}, lambda: lambda d=_words(GF32, 8, 4):
                            rs.encode_parity(d, GF32, 32),
                            [(ENC32, [P("K1_col"), P("K3_row")]
                              + [P("K4_col_pre"), P("K3_row")] * 3)]),
    "encode_lane_chunks": ({}, lambda: lambda d=_words(GF32, 16, 8):
                           rs.encode_parity(d, GF32, lane_chunks=2),
                           [(ENC32, [(ENC32, PAIR), (ENC32, PAIR)])]),
    "encode_blocks_wire16": ({}, lambda: lambda d=_bytes(8, 32):
                             rs.encode_blocks(d, GF16),
                             [(BLOCKS, [P("K8_col_wire16"),
                                        P("K9_seam_wire16"),
                                        P("K10_row_wire16"), JOIN])]),
    "encode_blocks_gf32": ({}, lambda: lambda d=_bytes(16, 64):
                           rs.encode_blocks(d, GF32),
                           [(BLOCKS, [(ENC32, PAIR)])]),
    "decode_prepared": ({}, lambda: _repair(True),
                        [(DEC, [P("K5_col_vec"), P("K6_seam_vec"),
                                P("K7_row_post_sel")])]),
    "decode_unmerged": ({}, lambda: _repair(False),
                        [(DEC, [P("K5_col_vec"), P("K6_seam_vec"),
                                P("K7_row_post")])]),
    "encode_lanes": ({"LANES_PAIR_ENABLED": True},
                     lambda: lambda d=_words(GF32, 32, 4):
                     rs.encode_parity(d, GF32),
                     [(ENC32, [P("K11_pair_lanes")])]),
    "encode_blocks_lanes": ({"LANES_PAIR_ENABLED": True},
                            lambda: lambda d=_bytes(32, 32):
                            rs.encode_blocks(d, GF16),
                            [(BLOCKS, [P("K12_pair_lanes_wire16"), JOIN])]),
    "encode_staged": ({"PAIR_ENABLED": False},
                      lambda: lambda d=_words(GF32, 16, 8):
                      rs.encode_parity(d, GF32), [(ENC32, STAGED)]),
    "decode_staged": ({"PAIR_ENABLED": False}, lambda: _repair(True),
                      [(DEC, [P("K5_col_vec"), P("K3_row"), P("K5_col_vec"),
                              P("K7_row_post_sel")])]),
}


@pytest.fixture(params=sorted(CASES))
def case(request, monkeypatch):
    switches, make, want = CASES[request.param]
    for name, value in switches.items():
        monkeypatch.setattr(ntt_mfa, name, value)
    return make(), want


def _tree(prof):
    """The ``fecc.`` spans of a finished profile as nested (name,
    children) lists, children in the order they started."""
    spans = sorted(((e.start_ns(), -(e.start_ns() + e.duration_ns()),
                     e.name()) for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("fecc.")))
    root: list = []
    stack = [(float("inf"), root)]
    for start, neg_end, name in spans:
        while start >= stack[-1][0]:
            stack.pop()
        node = (name, [])
        stack[-1][1].append(node)
        stack.append((-neg_end, node[1]))
    return root


def _same(a, b):
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b)) and len(a) == len(b)
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_scope_is_the_shared_null_context_while_nothing_records():
    assert not torch.autograd._profiler_enabled()
    assert profiling.scope("fecc.x") is profiling._OFF
    assert profiling.scope("fecc.y") is profiling._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.scope("fecc.x") is not profiling._OFF
    assert profiling.scope("fecc.x") is profiling._OFF


def test_no_span_opens_without_a_profiler(case, monkeypatch):
    call, _ = case

    def refuse(name):
        raise AssertionError(f"a span {name!r} opened")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    call()


def test_entry_span_holds_its_passes_in_order(case):
    call, want = case
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    assert _tree(prof) == want
    # host ops, not user annotations: the profiler draws no span of
    # theirs on the card's timeline
    kinds = {e.activity_type() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("fecc.")}
    assert kinds == {"cpu_op"}


def test_outputs_identical_with_the_profiler_on_and_off(case):
    call, _ = case
    off = call()
    with profile(activities=[ProfilerActivity.CPU]):
        on = call()
    assert _same(off, on)
    assert _same(off, call())
    assert set(ntt_mfa.LAUNCHES.values()) == {0}
