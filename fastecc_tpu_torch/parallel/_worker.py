"""A world of ranks for the sharded codec: :func:`launch` starts one
process per rank (``torch.multiprocessing``, the spawn start method) over
a ``file://`` rendezvous in a temporary directory, and each rank runs
:func:`_main`, which works through the job's cases and writes what it
found to ``rank{r}.json`` there. The CLI's ``scaling``, the tests and
``chip_smoke.py`` describe their runs as jobs.

A job is a dict: ``mesh`` (n_coeff, n_block), ``device`` ("cuda" or
"cpu"), ``cases`` (a list) and optionally ``out_dir`` (where cases with
``save`` write each rank's output shard as ``{name}.r{rank}.npy``) and
``threads`` (torch's intra-op threads a rank). A case is a dict:

  name, op      op: "ntt", "ntt_overlap", "encode", "encode_chain"
                (the encode's K = 1 chain at any width), "decode",
                "decode_prepared", "chain" (iNTT, output_transposed ->
                x table -> NTT, input_transposed) or "exchange"
                (``ntt_dist._exchange`` alone: ``split``, ``concat``);
  field         "GF32" or "GF16";
  input         {"npy": path, "transposed": bool} (a global array,
                sharded here), {"per_rank": path} ([world, ...]: rank r
                takes row r), {"seeded": [rows, lanes], "seed": s}
                (:func:`seeded_u32`; with "view": A, that array viewed
                [A, rows/A, lanes] and sharded as a transposed input)
                or {"codeword": [k, lanes], "seed": s, "e": e}
                (:func:`garbled_codeword`; the decode's input);
  args          keyword arguments of the op (inverse, chunks, n, ...);
                "erased" (a path to a .npy, or taken from a codeword
                input) and "table" (a .npy path: chain's [n] table);
  iters         timed calls after the first, untimed one (0: one call);
  save          write the output shard;
  expect_sha    every rank's expected :func:`digest` of its output shard
                (a list), checked here;
  want          a .npy path: the global result the shard is held to
                (``bit_exact``);
  profile       rank 0 profiles one more call (every rank runs it);
  spans         every rank runs one more call under ``torch.profiler``
                and reports its ``fecc.`` spans, its counts and whether
                its output has the first call's bits.

Each case reports, per rank: the exchanges, table multiplies and kernel
launches of one call, the timed samples (a barrier before and after
each, so a sample is the world's wall), the digest, the checks and the
case's whole wall (input, calls, hashing).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time

import numpy as np
import torch

def seeded_u32(p: int, shape, seed: int, device, row0: int = 0,
               row1: int | None = None) -> torch.Tensor:
    """Rows [row0, row1) of a [rows, ...] u32 array of uniform residues
    below ``p``, drawn on ``device`` in row chunks, each from a
    ``torch.Generator`` seeded ``seed + chunk``: any rank draws its own
    rows alone, and the card draws the same values for every caller."""
    from .. import gf
    rows, rest = shape[0], tuple(shape[1:])
    row1 = rows if row1 is None else row1
    per = max(1, (1 << 24) // max(1, int(np.prod(rest, dtype=np.int64))))
    dev = torch.device(device)
    parts = []
    for c in range(row0 // per, (row1 + per - 1) // per):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + c)
        r0, r1 = c * per, min((c + 1) * per, rows)
        v = torch.randint(0, p, (r1 - r0,) + rest, dtype=torch.int64,
                          device=dev, generator=gen)
        parts.append(gf.narrow(v).view(torch.int32)[
            max(row0, r0) - r0:min(row1, r1) - r0])
    return torch.cat(parts).view(torch.uint32)


def garbled_codeword(field, k: int, lanes: int, seed: int, e: int, device
                     ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """(the codeword ``rs.encode`` makes of :func:`seeded_u32` data
    [k, lanes] at rate 1/2, that codeword with ``e`` random rows
    overwritten with seeded garbage, those rows)."""
    from .. import rs
    n = 2 * k
    cw = rs.encode(seeded_u32(field.p, (k, lanes), seed, device), field, n)
    erased = np.sort(np.random.default_rng(seed).choice(n, size=e,
                                                         replace=False))
    bad = cw.view(torch.int32).clone()
    idx = torch.from_numpy(erased).to(bad.device)
    bad[idx] = seeded_u32(field.p, (e, lanes), seed + (1 << 20),
                          device).view(torch.int32)
    return cw, bad.view(torch.uint32), erased


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a u32 tensor's elements in row-major order."""
    a = t.view(torch.int32).contiguous().cpu().numpy()
    return hashlib.sha256(a.data).hexdigest()


def launch(job: dict, nprocs: int, timeout: float = 600.0) -> list[dict]:
    """Run ``job`` on a world of ``nprocs`` ranks and return each rank's
    report. The world is joined with ``timeout`` (s) and killed when it
    expires (``TimeoutError``); a rank that raises makes this raise."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="fecc_world_") as td:
        job = dict(job, world=nprocs, store=os.path.join(td, "store"),
                   result_dir=td)
        ctx = mp.start_processes(_main, args=(job,), nprocs=nprocs,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"a world of {nprocs} ranks did not "
                                       f"finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
        out = []
        for r in range(nprocs):
            with open(os.path.join(td, f"rank{r}.json")) as fh:
                out.append(json.load(fh))
        return out


# ---------------------------------------------------------------------------
# A rank.
# ---------------------------------------------------------------------------

def _main(rank: int, job: dict) -> None:
    import torch.distributed as dist

    from . import mesh as pmesh

    if job.get("threads"):
        torch.set_num_threads(job["threads"])
    dev = pmesh.init_process_group(rank, job["world"], job["store"],
                                   device=job["device"],
                                   timeout=job.get("timeout", 300.0))
    try:
        mesh = pmesh.make_mesh(*job["mesh"])
        report = {"rank": rank, "device": str(dev),
                  "backend": dist.get_backend(),
                  "coords": list(pmesh.coords(mesh)), "cases": {}}
        if dev.type == "cuda":
            report["mem_free_total"] = list(torch.cuda.mem_get_info(dev))
        for case in job["cases"]:
            report["cases"][case["name"]] = _run_case(case, job, mesh, rank)
        with open(os.path.join(job["result_dir"], f"rank{rank}.json"),
                  "w") as fh:
            json.dump(report, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _input(case: dict, mesh, rank: int, dev):
    """(this rank's input shard, erased rows or None)."""
    from ..interop import as_tensor, field_by_name
    from . import mesh as pmesh
    spec = case["input"]
    field = field_by_name(case["field"])
    if "npy" in spec:
        x = np.load(spec["npy"])
        return pmesh.shard(x, mesh, spec.get("transposed", False)), None
    if "per_rank" in spec:
        return as_tensor(np.load(spec["per_rank"])[rank], dev), None
    dc, db = mesh.shape
    ci, bi = pmesh.coords(mesh)
    if "seeded" in spec:
        rows, lanes = spec["seeded"]
        rr, lb = rows // dc, lanes // db
        if spec.get("view"):
            # the global [rows, L] viewed [A, rows/A, L], sharded on its
            # middle axis (an input_transposed input)
            a = spec["view"]
            bd = rows // a // dc
            x = seeded_u32(field.p, (rows, lanes), spec["seed"], dev)
            x = x.view(torch.int32).reshape(a, rows // a, lanes)
            return _lanes(x[:, ci * bd:(ci + 1) * bd], bi, lb), None
        x = seeded_u32(field.p, (rows, lanes), spec["seed"], dev,
                       ci * rr, (ci + 1) * rr)
        return _lanes(x, bi, lb), None
    k, lanes = spec["codeword"]
    _, bad, erased = garbled_codeword(field, k, lanes, spec["seed"],
                                      spec["e"], dev)
    rr, lb = 2 * k // dc, lanes // db
    return _lanes(bad[ci * rr:(ci + 1) * rr], bi, lb), erased


def _lanes(x: torch.Tensor, bi: int, lb: int) -> torch.Tensor:
    return x.view(torch.int32)[..., bi * lb:(bi + 1) * lb].contiguous(
        ).view(torch.uint32)


def _op(case: dict, mesh, x, erased):
    """The case's call as a function of the local input."""
    from .. import gf
    from ..decode import prepare_decode_tables
    from ..interop import field_by_name
    from ..ntt import mul_prepared
    from . import mesh as pmesh
    from . import ntt_dist as nd
    field = field_by_name(case["field"])
    args = dict(case.get("args", {}))
    op = case["op"]
    if "erased" in args:
        erased = np.load(args.pop("erased"))
    if op == "ntt":
        return lambda v: nd.ntt_sharded(v, field, mesh, **args)
    if op == "ntt_overlap":
        return lambda v: nd.ntt_sharded_overlap(v, field, mesh, **args)
    if op == "encode":
        return lambda v: nd.encode_parity_sharded(v, field, mesh, **args)
    if op == "encode_chain":
        return lambda v: nd._encode_chain(
            v, field, mesh, args.get("n", 2 * v.shape[0] * mesh.shape[0]))
    if op == "decode":
        return lambda v: nd.decode_sharded(v, erased, field, mesh)
    if op == "decode_prepared":
        n = x.shape[0] * mesh.shape[0]
        tables = [pmesh.shard(t.view(torch.int32).cpu().numpy().view(
            np.uint32), mesh) for t in prepare_decode_tables(
                erased, n, field, locator="host", device="cpu")]
        return lambda v: nd.decode_prepared_sharded(v, *tables, field, mesh)
    if op == "chain":
        table = gf.table(np.load(args["table"]), x.device)

        def chain(v):
            t = nd.ntt_sharded(v, field, mesh, inverse=True,
                               output_transposed=True)
            d, j = mesh.shape[0], mesh.get_local_rank("coeff")
            t = mul_prepared(field, t, nd._cols_of(
                table, t.shape[0], t.shape[1], d, j))
            return nd.ntt_sharded(t, field, mesh, input_transposed=True)
        return chain
    if op == "exchange":
        return lambda v: nd._exchange(v, mesh, args["split"], args["concat"])
    raise ValueError(f"unknown op {op!r}")


def _fence(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_case(case: dict, job: dict, mesh, rank: int) -> dict:
    import torch.distributed as dist

    from ..kernels import ntt_mfa, table
    from . import mesh as pmesh
    from .ntt_dist import COLLECTIVES, TABLE_MULS, reset_collectives

    dev = pmesh.rank_device()
    t_case = time.perf_counter()
    x, erased = _input(case, mesh, rank, dev)
    fn = _op(case, mesh, x, erased)
    res = {}
    _fence(dev)
    dist.barrier()
    reset_collectives()
    ntt_mfa.reset_launches()
    table.reset_launches()
    out = fn(x)
    _fence(dev)
    res["collectives"] = dict(COLLECTIVES)
    res["table_muls"] = dict(TABLE_MULS)
    res["launches"] = {k: v for k, v in {**ntt_mfa.LAUNCHES,
                                         **table.LAUNCHES}.items() if v}
    if case.get("spans"):
        res["spans"] = _spans(fn, x, out, dev)
    if case.get("save"):
        np.save(os.path.join(job["out_dir"], f"{case['name']}.r{rank}.npy"),
                out.view(torch.int32).cpu().numpy().view(np.uint32))
    if case.get("expect_sha"):
        res["sha256"] = digest(out)
        res["sha_match"] = res["sha256"] == case["expect_sha"][rank]
    if case.get("want"):
        res["bit_exact"] = bool(torch.equal(out.view(torch.int32).cpu(),
                                            pmesh.shard(np.load(case["want"]),
                                                        mesh, device="cpu")
                                            .view(torch.int32)))
    del out
    # the call above was the warm-up
    samples = []
    for _ in range(case.get("iters", 0)):
        _fence(dev)
        dist.barrier()
        t0 = time.perf_counter()
        out = fn(x)
        _fence(dev)
        dist.barrier()
        samples.append(time.perf_counter() - t0)
        del out
    res["samples"] = samples
    if case.get("profile"):
        res["profile"] = _profile(fn, x, dev, rank)
    res["case_s"] = time.perf_counter() - t_case
    return res


def _spans(fn, x, first, dev) -> dict:
    """One more call of ``fn`` under ``torch.profiler`` on this rank: its
    ``fecc.`` spans as [name, start ns, end ns] by start, its counts, and
    whether its output has the bits of ``first`` (the unprofiled call's).
    ``off_is_null``: ``profiling.scope`` was the shared null context just
    before the profiler started."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from ..utils import profiling
    from .ntt_dist import COLLECTIVES, TABLE_MULS, reset_collectives
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _fence(dev)
    dist.barrier()
    off_is_null = profiling.scope("fecc.dist.off") is profiling._OFF
    reset_collectives()
    with profile(activities=acts) as prof:
        out = fn(x)
        _fence(dev)
    spans = sorted(([e.name(), e.start_ns(), e.start_ns() + e.duration_ns()]
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("fecc.")),
                   key=lambda s: (s[1], -s[2]))
    return {"spans": spans, "collectives": dict(COLLECTIVES),
            "table_muls": dict(TABLE_MULS), "off_is_null": off_is_null,
            "same_bits": bool(torch.equal(out.view(torch.int32),
                                          first.view(torch.int32)))}


def _profile(fn, x, dev, rank: int):
    """One call of ``fn`` on every rank, rank 0's under torch.profiler:
    its wall, the device time by kind (the port's kernels, torch's
    elementwise arithmetic, its copies and concatenations, host-device
    copies, the rest: Gloo's own entries) and the six largest entries."""
    import torch.distributed as dist
    _fence(dev)
    dist.barrier()
    if rank or dev.type != "cuda":
        out = fn(x)
        _fence(dev)
        dist.barrier()
        return None
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device=dev)
        _fence(dev)
        t0 = time.perf_counter()
        out = fn(x)
        _fence(dev)
        wall = time.perf_counter() - t0
    dist.barrier()
    del out
    kinds = {"port_kernels": 0.0, "elementwise": 0.0, "copies": 0.0,
             "memcpy": 0.0, "other": 0.0}
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = evt.key
        low = key.lower()
        kind = ("port_kernels" if "(anonymous namespace)::" in key
                else "memcpy" if "Memcpy" in key or "Memset" in key
                else "copies" if "copy" in low or "cat" in low
                else "elementwise" if "elementwise" in low
                or "vectorized" in low or "reduce" in low
                else "other")
        kinds[kind] += us / 1e3
        rows.append([round(us / 1e3, 4), evt.count, key[:80]])
    rows.sort(reverse=True)
    return {"wall_ms": round(wall * 1e3, 4),
            "busy_ms": round(sum(kinds.values()), 4),
            "by_kind_ms": {k: round(v, 4) for k, v in kinds.items()},
            "top": rows[:6]}
