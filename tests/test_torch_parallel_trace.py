"""The sharded codec's spans and counts (fastecc_tpu_torch.parallel.ntt_dist)
on a world of four CPU processes over Gloo, spawned once for the module.

Each rank runs the sharded encode and the sharded decode once with no
profiler and once more under ``torch.profiler`` (``_worker``'s ``spans``
option). The tests hold the two calls' outputs to each other and the
gathered shards, tolerance 0, to the plain reference of the benchmark
(``ecbench/reference/rs.py``: int64 torch, nothing of the port), and the
profiled call's ``fecc.dist.*`` spans and :data:`ntt_dist.TABLE_MULS` to
the four-step's structure: 4 exchanges (two spans each: the pack and
launch, then the unpack), 3 table multiplies in the encode, 5 and one
1/N scale in the decode."""

import numpy as np
import pytest
import torch

from ecbench.reference import rs as ref
from fastecc_tpu_torch import fields
from fastecc_tpu_torch.parallel import _worker, mesh, ntt_dist
from fastecc_tpu_torch.utils import profiling

torch.set_num_threads(1)

FIELDS = [fields.GF32, fields.GF16]
OPS = ["enc", "dec"]
N, LANES, E, WORLD = 1 << 8, 16, 100, 4


def _u32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32)).view(torch.uint32)


def _inputs(field):
    """The numpy inputs of one field, and the reference's codeword."""
    rng = np.random.default_rng(0x7D15 + field.use_mont)
    data = rng.integers(0, field.p, size=(N // 2, LANES),
                        dtype=np.uint64).astype(np.uint32)
    f = ref.Field(field.name)
    cw = ref.i64_to_u32(f.codeword(ref.u32_to_i64(_u32(data)), N))
    cw = cw.view(torch.int32).numpy().view(np.uint32)
    erased = np.sort(rng.choice(N, size=E, replace=False))
    garbled = cw.copy()
    garbled[erased] = rng.integers(0, field.p, size=(E, LANES),
                                   dtype=np.uint64).astype(np.uint32)
    return {"data": data, "cw": cw, "erased": erased, "garbled": garbled}


INPUTS = {f.name: _inputs(f) for f in FIELDS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the ranks' output directory, every rank's report)."""
    tmp = tmp_path_factory.mktemp("parallel_trace")

    def npy(name, a):
        path = str(tmp / f"{name}.npy")
        np.save(path, a)
        return path
    cases = []
    for f in FIELDS:
        inp = INPUTS[f.name]
        base = {"field": f.name, "save": True, "spans": True}
        cases += [
            {"name": f"{f.name}_enc", "op": "encode",
             "input": {"npy": npy(f"{f.name}_data", inp["data"])}, **base},
            {"name": f"{f.name}_dec", "op": "decode",
             "input": {"npy": npy(f"{f.name}_garbled", inp["garbled"])},
             "args": {"erased": npy(f"{f.name}_erased", inp["erased"])},
             **base}]
    return tmp, _worker.launch({"mesh": (WORLD, 1), "device": "cpu",
                                "cases": cases, "out_dir": str(tmp),
                                "threads": 1}, WORLD, timeout=120)


def _gather(world, name):
    d, _ = world
    return np.concatenate([np.load(d / f"{name}.r{r}.npy")
                           for r in range(WORLD)])


def _cases(world, name):
    return [rep["cases"][name] for rep in world[1]]


def _tree(spans):
    """[name, start, end] spans as nested (name, children) lists, children
    in the order they started."""
    root: list = []
    stack = [(float("inf"), root)]
    for name, start, end in sorted(spans, key=lambda s: (s[1], -s[2])):
        while start >= stack[-1][0]:
            stack.pop()
        node = (name, [])
        stack[-1][1].append(node)
        stack.append((end, node[1]))
    return root


X = ("fecc.dist.exchange", [])      # a pack and launch, or an unpack
M = ("fecc.dist.mul_table", [])
S = ("fecc.dist.scale", [])
K = [("fecc.pass.K1_col", []), ("fecc.pass.K3_row", [])]
# iNTT handing off transposed, then NTT taking the transposed layout:
# two exchanges each
INTT_T = [X, X, *K, M, X, X, *K]
NTT_T = [*K, M, X, X, *K, X, X]
TREES = {
    "enc": [("fecc.dist.encode_parity_sharded", [
        ("fecc.dist.ntt_sharded", INTT_T), M,
        ("fecc.dist.ntt_sharded", NTT_T)])],
    "dec": [("fecc.dist.decode_sharded", [
        ("fecc.dist.decode_prepared_sharded", [
            M, ("fecc.dist.ntt_sharded", INTT_T + [S]), M,
            ("fecc.dist.ntt_sharded", NTT_T), M])])],
}
# table multiplies of a call, each over a rank's [n / 4, L] elements
# (the encode's n is the data's k)
MULS = {"enc": (3, 0), "dec": (5, 1)}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_profiled_call_has_the_unprofiled_bits(world, field, op):
    for c in _cases(world, f"{field.name}_{op}"):
        assert c["spans"]["same_bits"]


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_encode_matches_the_plain_reference(world, field):
    inp = INPUTS[field.name]
    f = ref.Field(field.name)
    want = f.encode_parity(ref.u32_to_i64(_u32(inp["data"])), N)
    got = _gather(world, f"{field.name}_enc")
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())
    np.testing.assert_array_equal(got, inp["cw"][1::2])


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_decode_gives_back_the_reference_codeword(world, field):
    np.testing.assert_array_equal(_gather(world, f"{field.name}_dec"),
                                  INPUTS[field.name]["cw"])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_profiled_call_holds_the_four_step_spans(world, field, op):
    """One entry span; in it every exchange, table multiply and scale in
    the order the four-step runs them, the local passes between."""
    for c in _cases(world, f"{field.name}_{op}"):
        spans = c["spans"]["spans"]
        assert _tree(spans) == TREES[op]
        names = [n for n, _, _ in spans]
        assert names.count("fecc.dist.exchange") == 2 * 4
        assert c["spans"]["collectives"]["all_to_all"] == 4


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_table_muls_count_the_multiplies_and_their_elements(world, field,
                                                            op):
    muls, scales = MULS[op]
    rows = (N // 2 if op == "enc" else N) // WORLD
    want = {"mul_table": muls, "mul_table_elems": muls * rows * LANES,
            "scale": scales}
    for c in _cases(world, f"{field.name}_{op}"):
        assert c["table_muls"] == want
        assert c["spans"]["table_muls"] == want
        names = [n for n, _, _ in c["spans"]["spans"]]
        assert names.count("fecc.dist.mul_table") == muls
        assert names.count("fecc.dist.scale") == scales


def test_scope_is_the_shared_null_context_without_a_profiler(world):
    assert not torch.autograd._profiler_enabled()
    assert profiling.scope("fecc.dist.exchange") is profiling._OFF
    for f in FIELDS:
        for op in OPS:
            assert all(c["spans"]["off_is_null"]
                       for c in _cases(world, f"{f.name}_{op}"))


def test_no_span_opens_without_a_profiler(tmp_path, monkeypatch):
    """In-process, a world of one CPU rank: the sharded entries and their
    table multiplies open no profiler range while nothing records, and
    reset_collectives zeroes both counters."""
    import torch.distributed as dist

    def refuse(name):
        raise AssertionError(f"a span {name!r} opened")

    mesh.init_process_group(0, 1, tmp_path / "store", device="cpu",
                            timeout=60)
    try:
        m = mesh.make_mesh(1, 1)
        inp = INPUTS["GF32"]
        monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
        ntt_dist.reset_collectives()
        ntt_dist.encode_parity_sharded(inp["data"], fields.GF32, m)
        got = ntt_dist.decode_sharded(inp["garbled"], inp["erased"],
                                      fields.GF32, m)
        np.testing.assert_array_equal(got.view(torch.int32).numpy().view(
            np.uint32), inp["cw"])
        # one rank: no exchange and no four-step twiddle; the encode's
        # coset multiply, the decode's three table multiplies and its 1/N
        # scale still run as torch ops
        assert ntt_dist.COLLECTIVES["all_to_all"] == 0
        assert ntt_dist.TABLE_MULS["mul_table"] == 1 + 3
        assert ntt_dist.TABLE_MULS["scale"] == 1
        ntt_dist.reset_collectives()
        assert set(ntt_dist.TABLE_MULS.values()) == {0}
    finally:
        dist.destroy_process_group()
