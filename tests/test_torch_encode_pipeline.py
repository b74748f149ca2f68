"""The sharded encode's pipeline over lane chunks
(fastecc_tpu_torch.parallel.ntt_dist.encode_parity_sharded at K > 1) on
worlds of CPU processes over Gloo, against the reference
(fastecc_tpu.parallel and fastecc_tpu.rs).

The worlds (2x1 and 4x1, spawned together for the module through
``parallel/_worker.py``) encode data of the narrowest lane width that
splits into ``PIPE_CHUNKS`` chunks, so every rank runs K = PIPE_CHUNKS
chunks, each with the four exchanges of the ``ntt_sharded`` chain. The
tests hold the gathered parity, tolerance 0, to the reference's sharded
and single-device encodes and to the K = 1 chain on the same input; the
exchanges to 4K a call (all of them waited for after another chunk's
step, so overlapped); and a profiled call's spans to one
``fecc.dist.mul_table`` a table multiply and two ``fecc.dist.exchange``
an exchange, flat under the entry's span.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastecc_tpu import fields as jfields
from fastecc_tpu import rs as jrs
from fastecc_tpu.parallel import make_mesh as jmake_mesh
from fastecc_tpu.parallel import ntt_dist as jdist
from fastecc_tpu_torch import fields
from fastecc_tpu_torch.parallel import _worker, ntt_dist

torch.set_num_threads(1)

FIELDS = [fields.GF32, fields.GF16]
MESHES = [(2, 1), (4, 1)]
K_ROWS = 1 << 7
K = ntt_dist.PIPE_CHUNKS
LANES = K * ntt_dist.PIPE_MIN_LANES     # the narrowest width that chunks


def _data(field):
    rng = np.random.default_rng(0x91BE + field.use_mont)
    return rng.integers(0, field.p, size=(K_ROWS, LANES),
                        dtype=np.uint64).astype(np.uint32)


DATA = {f.name: _data(f) for f in FIELDS}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """mesh -> (its output directory, every rank's report)."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("encode_pipeline")
    cases = []
    for f in FIELDS:
        path = str(tmp / f"{f.name}_data.npy")
        np.save(path, DATA[f.name])
        base = {"field": f.name, "input": {"npy": path}, "save": True}
        cases += [{"name": f"{f.name}_enc", "op": "encode", "spans": True,
                   **base},
                  {"name": f"{f.name}_chain", "op": "encode_chain", **base}]
    cases.append({"name": "GF32_enc_c4", "op": "encode",
                  "args": {"n": 4 * K_ROWS}, "field": "GF32",
                  "input": {"npy": str(tmp / "GF32_data.npy")},
                  "save": True})

    def world(m):
        d = tmp / f"m{m[0]}x{m[1]}"
        d.mkdir()
        return d, _worker.launch({"mesh": m, "device": "cpu",
                                  "cases": cases, "out_dir": str(d),
                                  "threads": 1}, m[0] * m[1], timeout=240)
    with ThreadPoolExecutor(len(MESHES)) as pool:
        return dict(zip(MESHES, pool.map(world, MESHES)))


def _gather(worlds, m, name):
    d, _ = worlds[m]
    return np.concatenate([np.load(d / f"{name}.r{r}.npy")
                           for r in range(m[0] * m[1])])


def _cases(worlds, m, name):
    return [rep["cases"][name] for rep in worlds[m][1]]


@functools.lru_cache(maxsize=None)
def _jmesh(m):
    return jmake_mesh(*m)


def _ids(m):
    return f"{m[0]}x{m[1]}"


def test_chunks_follow_the_lane_width():
    """K from the local lanes alone: PIPE_CHUNKS chunks of at least
    PIPE_MIN_LANES each, else 1 (the chain: the 16-lane worlds of
    tests/test_torch_parallel.py, the 1024-lane ones of the CLI)."""
    for lanes, want in ((16, 1), (1024, 1), (LANES - K, 1), (LANES + 2, 1),
                        (LANES, K), (2 * LANES, K), (8192, K)):
        assert ntt_dist._pipe_chunks(lanes) == want, lanes


@pytest.mark.parametrize("chunks", [1, 2, 4, 8])
def test_wavefront_runs_each_round_newest_chunk_first(chunks):
    """Round r runs step r - i of every started chunk i, the last started
    first; every wait but a lone chunk's follows another chunk's step."""
    steps = 5
    order = []

    def chunk(i):
        for s in range(steps):
            order.append((i, s))
            if s < steps - 1:
                yield object()

    ntt_dist.reset_collectives()
    ntt_dist._wavefront([chunk(i) for i in range(chunks)])
    want = [(i, r - i) for r in range(chunks + steps - 1)
            for i in range(chunks - 1, -1, -1) if 0 <= r - i < steps]
    assert order == want
    waits = chunks * (steps - 1)
    assert ntt_dist.COLLECTIVES["all_to_all_overlapped"] == (
        waits if chunks > 1 else 0)


@pytest.mark.parametrize("m", MESHES, ids=_ids)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_chunked_encode_matches_reference(worlds, field, m):
    ref, data = jfields.FIELDS[field.name], DATA[field.name]
    got = _gather(worlds, m, f"{field.name}_enc")
    np.testing.assert_array_equal(got, np.asarray(
        jrs.encode(jnp.asarray(data), ref))[1::2])
    np.testing.assert_array_equal(got, np.asarray(
        jdist.encode_parity_sharded_jit(jnp.asarray(data), ref, _jmesh(m))))


@pytest.mark.parametrize("m", MESHES, ids=_ids)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_chunked_encode_has_the_chains_bits(worlds, field, m):
    np.testing.assert_array_equal(_gather(worlds, m, f"{field.name}_enc"),
                                  _gather(worlds, m, f"{field.name}_chain"))


@pytest.mark.parametrize("m", MESHES, ids=_ids)
def test_chunked_encode_at_rate_one_quarter(worlds, m):
    """c = 4: 3 cosets a chunk, each unpacked into its rows of the
    [k/D, c - 1, L] parity; 2c exchanges a chunk."""
    ref, data = jfields.FIELDS["GF32"], DATA["GF32"]
    np.testing.assert_array_equal(
        _gather(worlds, m, "GF32_enc_c4"), np.asarray(jrs.encode_parity_jit(
            jnp.asarray(data), ref, n=4 * K_ROWS)))
    for c in _cases(worlds, m, "GF32_enc_c4"):
        assert c["collectives"]["all_to_all"] == 8 * K


@pytest.mark.parametrize("m", MESHES, ids=_ids)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_chunked_encode_counts_4k_exchanges_all_overlapped(worlds, field,
                                                           m):
    """4 exchanges a chunk, each waited for after another chunk's step;
    the chain's 4 none; both send the same bytes."""
    for enc, chain in zip(_cases(worlds, m, f"{field.name}_enc"),
                          _cases(worlds, m, f"{field.name}_chain")):
        got, one = enc["collectives"], chain["collectives"]
        assert got["all_to_all"] == 4 * K
        assert got["all_to_all_overlapped"] == 4 * K
        assert one["all_to_all"] == 4
        assert one["all_to_all_overlapped"] == 0
        assert got["all_to_all_bytes"] == one["all_to_all_bytes"] > 0


@pytest.mark.parametrize("m", MESHES, ids=_ids)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_profiled_chunked_encode_spans(worlds, field, m):
    """Under the profiler: the unprofiled call's bits; one entry span and
    in it, flat, every exchange's two spans, one fecc.dist.mul_table a
    table multiply (3 a chunk) and the local passes; the counts as the
    unprofiled call's."""
    rows = K_ROWS // m[0]
    want = {"mul_table": 3 * K, "mul_table_elems": 3 * rows * LANES,
            "scale": 0}
    for c in _cases(worlds, m, f"{field.name}_enc"):
        sp = c["spans"]
        assert sp["same_bits"]
        assert c["table_muls"] == sp["table_muls"] == want
        assert sp["collectives"] == c["collectives"]
        names = [n for n, _, _ in sp["spans"]]
        assert names[0] == "fecc.dist.encode_parity_sharded"
        assert names.count("fecc.dist.encode_parity_sharded") == 1
        _, start, end = sp["spans"][0]
        assert all(start <= s and e <= end for _, s, e in sp["spans"])
        assert "fecc.dist.ntt_sharded" not in names
        assert names.count("fecc.dist.mul_table") == 3 * K
        assert names.count("fecc.dist.exchange") == 2 * 4 * K
        assert set(names[1:]) == {"fecc.dist.exchange",
                                  "fecc.dist.mul_table", "fecc.pass.K1_col",
                                  "fecc.pass.K3_row"}
