"""Port vs reference: the sharded codec (fastecc_tpu_torch.parallel vs
fastecc_tpu.parallel) on worlds of CPU processes over Gloo.

One world a mesh (2x1, 4x1, 2x2 and the 1x4 passthrough, the meshes of
tests/test_dist.py where four processes allow), the four spawned once
for the module, together, each with a file store under a temporary
directory and joined with a timeout; every rank writes its output shards as .npy, and the tests
gather them here and hold them, tolerance 0, to the reference's sharded
programs on the same mesh shape over conftest's virtual devices and to
its single-device functions, on the same numpy inputs. The exchanges
alone are held to a numpy model of the tiled all-to-all.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastecc_tpu import decode as jdecode
from fastecc_tpu import fields as jfields
from fastecc_tpu import ntt as jntt
from fastecc_tpu import rs as jrs
from fastecc_tpu.parallel import make_mesh as jmake_mesh
from fastecc_tpu.parallel import ntt_dist as jdist
from fastecc_tpu_torch import fields
from fastecc_tpu_torch.parallel import _worker, mesh, ntt_dist

torch.set_num_threads(1)

FIELDS = [fields.GF32, fields.GF16]
MESHES = [(2, 1), (4, 1), (2, 2), (1, 4)]
N, LANES, E = 1 << 8, 16, 100
# [world, ...] per-rank inputs of the three exchanges: (shape a rank,
# split axis, concat axis); the split axes divide by 4
EXCHANGES = {"1": ((4, 8, 3), 1, 0), "2": ((8, 4, 3), 0, 1),
             "3": ((8, 4, 3), 0, 1)}


def rand_field(rng, field, shape):
    return rng.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _inputs(field):
    """The numpy inputs of one field (the same in every world)."""
    rng = np.random.default_rng(0x5A2D + field.use_mont)
    ref = jfields.FIELDS[field.name]
    x = rand_field(rng, field, (N, LANES))
    data = rand_field(rng, field, (N // 2, LANES))
    cw = np.asarray(jrs.encode(jnp.asarray(data), ref, N))
    erased = np.sort(rng.choice(N, size=E, replace=False))
    garbled = cw.copy()
    garbled[erased] = rand_field(rng, field, (E, LANES))
    table = np.asarray(jntt.prepare_consts(ref, rand_field(rng, field, (N,))))
    c = 1 << (N.bit_length() // 2)      # the transposed layouts' inner axis
    return {"x": x, "data": data, "cw": cw, "erased": erased,
            "garbled": garbled, "table": table,
            "xt": x.reshape(N // c, c, LANES)}


INPUTS = {f.name: _inputs(f) for f in FIELDS}


def _cases(tmp):
    def npy(name, a):
        path = str(tmp / f"{name}.npy")
        np.save(path, a)
        return path
    cases = []
    for f in FIELDS:
        inp = {k: npy(f"{f.name}_{k}", v) for k, v in INPUTS[f.name].items()}
        base = {"field": f.name, "save": True}
        x = {"npy": inp["x"]}
        cases += [
            {"name": f"{f.name}_ntt", "op": "ntt", "input": x, **base},
            {"name": f"{f.name}_intt", "op": "ntt", "input": x,
             "args": {"inverse": True}, **base},
            {"name": f"{f.name}_out_t", "op": "ntt", "input": x,
             "args": {"inverse": True, "output_transposed": True}, **base},
            {"name": f"{f.name}_in_t", "op": "ntt",
             "input": {"npy": inp["xt"], "transposed": True},
             "args": {"input_transposed": True}, **base},
            {"name": f"{f.name}_chain", "op": "chain", "input": x,
             "args": {"table": inp["table"]}, **base},
            {"name": f"{f.name}_ov2", "op": "ntt_overlap", "input": x,
             "args": {"chunks": 2}, **base},
            {"name": f"{f.name}_ov4", "op": "ntt_overlap", "input": x,
             "args": {"chunks": 4, "inverse": True}, **base},
            {"name": f"{f.name}_enc", "op": "encode",
             "input": {"npy": inp["data"]}, **base},
            {"name": f"{f.name}_dec", "op": "decode",
             "input": {"npy": inp["garbled"]},
             "args": {"erased": inp["erased"]}, **base},
        ]
    for name, (shape, split, concat) in EXCHANGES.items():
        g = np.arange(4 * np.prod(shape), dtype=np.uint32).reshape(
            (4,) + shape)
        cases.append({"name": f"a2a{name}", "op": "exchange",
                      "field": "GF32", "input": {"per_rank": npy(
                          f"a2a{name}", g)},
                      "args": {"split": split, "concat": concat},
                      "save": True})
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """mesh -> (its output directory, every rank's report)."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("parallel")
    cases = _cases(tmp)

    def world(m):
        d = tmp / f"m{m[0]}x{m[1]}"
        d.mkdir()
        return d, _worker.launch({"mesh": m, "device": "cpu",
                                  "cases": cases, "out_dir": str(d),
                                  "threads": 1}, m[0] * m[1], timeout=120)
    # the worlds start together: most of a world's time is its start
    with ThreadPoolExecutor(len(MESHES)) as pool:
        return dict(zip(MESHES, pool.map(world, MESHES)))


def _gather(worlds, m, name, transposed=False):
    """The global array from the ranks' .npy shards (rank r at coeff
    r // Db, block r % Db; rows, or the middle axis when transposed)."""
    d, _ = worlds[m]
    dc, db = m
    parts = [np.load(d / f"{name}.r{r}.npy") for r in range(dc * db)]
    ax = 1 if transposed else 0
    rows = [np.concatenate(parts[ci * db:(ci + 1) * db], axis=-1)
            for ci in range(dc)]
    return np.concatenate(rows, axis=ax)


def _counts(worlds, m, name):
    return {r["cases"][name]["collectives"]["all_to_all"]
            for r in worlds[m][1]}


@functools.lru_cache(maxsize=None)
def _jmesh(m):
    return jmake_mesh(*m)


def _ids(m):
    return f"{m[0]}x{m[1]}"


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("m", MESHES, ids=_ids)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_ntt_sharded_matches_reference(worlds, field, m, inverse):
    ref, x = jfields.FIELDS[field.name], INPUTS[field.name]["x"]
    got = _gather(worlds, m, f"{field.name}_{'intt' if inverse else 'ntt'}")
    np.testing.assert_array_equal(got, np.asarray(
        jntt.ntt(jnp.asarray(x), ref, inverse=inverse)))
    np.testing.assert_array_equal(got, np.asarray(jdist.ntt_sharded_jit(
        jnp.asarray(x), ref, _jmesh(m), inverse=inverse)))


@pytest.mark.parametrize("layout", ["output", "input"])
@pytest.mark.parametrize("m", MESHES, ids=_ids)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_transposed_layouts_match_reference(worlds, field, m, layout):
    """output_transposed: the iNTT viewed [R, C, L], inner axis sharded;
    input_transposed: an [A, B, L] input split C = A, R = B."""
    ref, inp = jfields.FIELDS[field.name], INPUTS[field.name]
    if layout == "output":
        got = _gather(worlds, m, f"{field.name}_out_t", transposed=True)
        want = jdist.ntt_sharded_jit(jnp.asarray(inp["x"]), ref, _jmesh(m),
                                     inverse=True, output_transposed=True)
        assert got.shape == (16, 16, LANES)
        np.testing.assert_array_equal(got.reshape(N, LANES), np.asarray(
            jntt.ntt(jnp.asarray(inp["x"]), ref, inverse=True)))
    else:
        got = _gather(worlds, m, f"{field.name}_in_t")
        want = jdist.ntt_sharded_jit(jnp.asarray(inp["xt"]), ref,
                                     _jmesh(m), input_transposed=True)
        np.testing.assert_array_equal(got, np.asarray(
            jntt.ntt(jnp.asarray(inp["x"]), ref)))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("m", MESHES, ids=_ids)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_transposed_handoff_matches_plain(worlds, field, m):
    """iNTT (output_transposed) -> x table -> NTT (input_transposed) ==
    ntt(intt(x) * v) on one device, in 4 exchanges (0 without a coeff
    axis)."""
    ref, inp = jfields.FIELDS[field.name], INPUTS[field.name]
    vp = jnp.asarray(inp["table"])
    want = jntt.ntt(jntt.mul_prepared(
        ref, jntt.intt(jnp.asarray(inp["x"]), ref), vp[:, None]), ref)
    np.testing.assert_array_equal(
        _gather(worlds, m, f"{field.name}_chain"), np.asarray(want))
    assert _counts(worlds, m, f"{field.name}_chain") == {
        4 if m[0] > 1 else 0}


@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("m", MESHES, ids=_ids)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_overlap_matches_reference(worlds, field, m, chunks):
    """The double-buffered form: the reference's bits at chunks 2
    (forward) and 4 (inverse), 3 exchanges a chunk."""
    ref, x = jfields.FIELDS[field.name], INPUTS[field.name]["x"]
    inverse = chunks == 4
    got = _gather(worlds, m, f"{field.name}_ov{chunks}")
    np.testing.assert_array_equal(got, np.asarray(
        jntt.ntt(jnp.asarray(x), ref, inverse=inverse)))
    np.testing.assert_array_equal(got, np.asarray(
        jdist.ntt_sharded_overlap_jit(jnp.asarray(x), ref, _jmesh(m),
                                      inverse=inverse, chunks=chunks)))
    assert _counts(worlds, m, f"{field.name}_ov{chunks}") == {
        3 * chunks if m[0] > 1 else 0}


@pytest.mark.parametrize("m", MESHES, ids=_ids)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_encode_parity_sharded_matches_reference(worlds, field, m):
    ref, data = jfields.FIELDS[field.name], INPUTS[field.name]["data"]
    got = _gather(worlds, m, f"{field.name}_enc")
    np.testing.assert_array_equal(got, np.asarray(
        jrs.encode_parity_jit(jnp.asarray(data), ref)))
    np.testing.assert_array_equal(got, np.asarray(
        jdist.encode_parity_sharded_jit(jnp.asarray(data), ref, _jmesh(m))))


@pytest.mark.parametrize("m", MESHES, ids=_ids)
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_decode_sharded_matches_reference(worlds, field, m):
    """Sharded decode == the codeword == the reference's sharded and
    single-device decodes."""
    ref, inp = jfields.FIELDS[field.name], INPUTS[field.name]
    got = _gather(worlds, m, f"{field.name}_dec")
    np.testing.assert_array_equal(got, inp["cw"])
    np.testing.assert_array_equal(got, np.asarray(jdecode.decode_host_prepared(
        jnp.asarray(inp["garbled"]), inp["erased"], ref)))
    np.testing.assert_array_equal(got, np.asarray(jdist.decode_sharded(
        jnp.asarray(inp["garbled"]), inp["erased"], ref, _jmesh(m))))


@pytest.mark.parametrize("m", MESHES, ids=_ids)
def test_collectives_per_program(worlds, m):
    """The reference's all_to_all counts (tests/test_dist.py:163-189):
    3 a transform, 4 for the encode and the decode pairs, 2 for each
    transposed end; none without a coeff axis. Every rank counts the
    same."""
    d = m[0] > 1
    for f in FIELDS:
        for name, want in (("ntt", 3), ("intt", 3), ("enc", 4), ("dec", 4),
                           ("out_t", 2), ("in_t", 2)):
            assert _counts(worlds, m, f"{f.name}_{name}") == {
                want if d else 0}, (f.name, name)


def _a2a_model(g, m, split, concat):
    """jax.lax.all_to_all(tiled=True) over the coeff axis, in numpy: rank
    (ci, bi) receives chunk ci of each coeff peer's input, in peer
    order."""
    dc, db = m
    out = []
    for r in range(dc * db):
        ci, bi = divmod(r, db)
        out.append(np.concatenate(
            [np.split(g[i * db + bi], dc, axis=split)[ci]
             for i in range(dc)], axis=concat))
    return out


@pytest.mark.parametrize("which", sorted(EXCHANGES))
@pytest.mark.parametrize("m", MESHES, ids=_ids)
def test_exchange_alone_matches_tiled_all_to_all(worlds, m, which):
    """Each of the four-step's three exchanges alone, every rank's output
    against the numpy model (index maps in ``ntt_dist._exchange``)."""
    d, rep = worlds[m]
    shape, split, concat = EXCHANGES[which]
    g = np.arange(4 * np.prod(shape), dtype=np.uint32).reshape((4,) + shape)
    for r, want in enumerate(_a2a_model(g, m, split, concat)):
        np.testing.assert_array_equal(np.load(d / f"a2a{which}.r{r}.npy"),
                                      want)
    assert _counts(worlds, m, f"a2a{which}") == {1}


@pytest.mark.parametrize("m", MESHES, ids=_ids)
def test_worlds_report_gloo_on_the_cpu(worlds, m):
    for r, rep in enumerate(worlds[m][1]):
        assert rep["backend"] == "gloo"
        assert rep["device"] == "cpu"
        assert rep["coords"] == [r // m[1], r % m[1]]


def test_split_dims_needs_n_at_least_d_squared():
    """N < D^2 raises (the reference asserts), as does a c_dim that does
    not divide N; a valid split is the reference's."""
    with pytest.raises(ValueError, match="divide"):
        ntt_dist._split_dims(16, 8, None)
    with pytest.raises(ValueError, match="divide"):
        ntt_dist._split_dims(64, 2, 48)
    for n, d in ((1 << 8, 2), (1 << 8, 4), (1 << 10, 8)):
        assert ntt_dist._split_dims(n, d, None) == jdist._split_dims(
            n, d, None)


@pytest.fixture
def one_rank(tmp_path):
    """This process as a world of one CPU rank."""
    import torch.distributed as dist
    dev = mesh.init_process_group(0, 1, tmp_path / "store", device="cpu",
                                  timeout=60)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def test_make_mesh_covers_the_world(one_rank):
    """A mesh larger or smaller than the world raises ValueError (the
    reference asserts and may leave devices idle); the default is the
    reference's, all on coeff."""
    assert one_rank == torch.device("cpu")
    m = mesh.make_mesh()
    assert tuple(m.shape) == (1, 1)
    assert m.mesh_dim_names == ("coeff", "block")
    for shape in ((2, 1), (1, 2), (4, 4)):
        with pytest.raises(ValueError, match="covers the whole world"):
            mesh.make_mesh(*shape)
    assert [type(p).__name__ for p in mesh.codeword_sharding(m)] == [
        "Shard", "Shard"]
    assert [type(p).__name__ for p in mesh.replicated(m)] == [
        "Replicate", "Replicate"]


def test_one_rank_world_is_the_passthrough(one_rank):
    """In-process: shard/gather round-trip, and a 1x1 mesh runs every
    entry point as the single-device port with no exchange."""
    from fastecc_tpu_torch import ntt, rs
    from fastecc_tpu_torch.interop import to_numpy_u32
    field, inp = fields.GF32, INPUTS["GF32"]
    m = mesh.make_mesh(1, 1)
    x = mesh.shard(inp["x"], m)
    np.testing.assert_array_equal(mesh.gather(x, m), inp["x"])
    ntt_dist.reset_collectives()
    np.testing.assert_array_equal(
        to_numpy_u32(ntt_dist.ntt_sharded(x, field, m, inverse=True)),
        to_numpy_u32(ntt.ntt_auto(x, field, inverse=True)))
    np.testing.assert_array_equal(
        to_numpy_u32(ntt_dist.encode_parity_sharded(inp["data"], field, m)),
        to_numpy_u32(rs.encode_parity(inp["data"], field, device="cpu")))
    got = ntt_dist.decode_sharded(inp["garbled"], inp["erased"], field, m)
    np.testing.assert_array_equal(to_numpy_u32(got), inp["cw"])
    assert ntt_dist.COLLECTIVES["all_to_all"] == 0
    with pytest.raises(ValueError, match="transposed"):
        ntt_dist.ntt_sharded(x, field, m, input_transposed=True)


def test_init_without_a_card_raises(tmp_path):
    """A rank's device defaults to the card: without one (and without
    device="cpu") joining a world raises before any rendezvous."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_process_group(0, 1, tmp_path / "store")
    assert not (tmp_path / "store").exists()


def test_a_failing_rank_fails_the_world(tmp_path):
    """A rank that raises makes launch raise (the others are stopped)."""
    with pytest.raises(Exception, match="unknown op"):
        _worker.launch({"mesh": (2, 1), "device": "cpu", "threads": 1,
                        "cases": [{"name": "bad", "op": "nope",
                                   "field": "GF32",
                                   "input": {"seeded": [16, 2], "seed": 0}}]},
                       2, timeout=120)

