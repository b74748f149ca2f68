"""What torch.distributed offers on the card(s) of the machine it runs
on, for the sharded codec (fastecc_tpu_torch.parallel):

    python3 dist_probe.py          # on a machine with a card
    python3 dist_probe.py cpu      # Gloo worlds on the CPU only
    python3 dist_probe.py pipeline [cpu]   # the sharded encode's pipeline

Starts worlds of 1, 2 and 4 ranks (spawned processes, a file:// store) and
prints, per rank: whether all_to_all_single takes int32 and uint32
tensors, whether the async form, all_gather and a ('coeff', 'block')
DeviceMesh's coeff group work, and the time of an all_to_all_single of
256 MiB or 1 GiB a rank (GiB a second moved to other ranks), after one
untimed call. On the card it also tries NCCL with two ranks on one GPU
(which NCCL refuses) and with one rank.

``pipeline`` (four cards, NCCL; ``pipeline cpu``: four Gloo ranks at a
small size) measures what ``ntt_dist.encode_parity_sharded``'s lane
pipeline rests on, and writes it to ``chiprun_out/pipeline_probe.json``:
whether one async all_to_all_single (1 GiB a rank) runs on rank 0's card
beside a K1 -> K3 transform enqueued after it; K1 -> K3's time an
element by chunk width at the four-card cell's shapes; and the sharded
encode of that cell's stripe ([2^17, 8192] a rank) at K = 1, 4, 8, 16
chunks (``PIPE_CHUNKS`` set for the run) on the mesh's coeff group and on
groups with other NCCL options, each against K = 1's bits, its median
wall, peak memory and exchange counts, and rank 0's profiled call (its
trace under ``chiprun_out/``): busy time and NCCL's time with no other
operation beside it.
"""
import datetime
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEV = sys.argv[1] if len(sys.argv) > 1 else "cuda"


def worker(rank, world, store, backend, mb, out_dir):
    log = []
    try:
        if DEV == "cuda":
            torch.cuda.set_device(0)
        dev = torch.device(DEV, 0) if DEV == "cuda" else torch.device("cpu")
        t0 = time.perf_counter()
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        log.append(f"init {time.perf_counter() - t0:.2f}s")
        x = torch.arange(world * 4, dtype=torch.int32, device=dev) + 100 * rank
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        log.append(f"a2a int32 {y.tolist()}")
        try:
            xu = x.view(torch.uint32)
            yu = torch.empty_like(xu)
            dist.all_to_all_single(yu, xu)
            log.append("a2a uint32 ok")
        except Exception as e:  # noqa: BLE001
            log.append(f"a2a uint32 refused: {str(e).splitlines()[0][:80]}")
        w = dist.all_to_all_single(y, x, async_op=True)
        w.wait()
        log.append(f"async ok {y.tolist()}")
        g = torch.empty(world * x.numel(), dtype=torch.int32, device=dev)
        dist.all_gather_into_tensor(g, x)
        log.append(f"all_gather ok {g[:8].tolist()}")
        if world == 1:
            from torch.distributed.device_mesh import DeviceMesh
            m = DeviceMesh(DEV, torch.arange(1).reshape(1, 1),
                           mesh_dim_names=("coeff", "block"))
            log.append(f"mesh 1x1 ok {m.get_group('coeff').size()}")
        if world >= 2 and world % 2 == 0:
            from torch.distributed.device_mesh import DeviceMesh
            m = DeviceMesh(DEV, torch.arange(world).reshape(world // 2, 2),
                           mesh_dim_names=("coeff", "block"))
            gc = m.get_group("coeff")
            xs = x[: (world // 2) * 2].contiguous()
            zs = torch.empty_like(xs)
            dist.all_to_all_single(zs, xs, group=gc)
            log.append(f"mesh coeff group ok {zs.tolist()} coord "
                       f"{m.get_coordinate()}")
        n = (mb << 20) // 4
        big = torch.randint(0, 1 << 30, (n,), dtype=torch.int32, device=dev)
        out = torch.empty_like(big)
        for i in range(4):
            if DEV == "cuda":
                torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_to_all_single(out, big)
            if DEV == "cuda":
                torch.cuda.synchronize()
            dist.barrier()
            dt = time.perf_counter() - t0
            if i:
                log.append(f"a2a {mb} MiB/rank: {dt * 1e3:.1f} ms = "
                           f"{mb / 1024 * (world - 1) / world / dt:.2f} GiB/s "
                           f"moved per rank")
        ok = True
    except Exception as e:  # noqa: BLE001
        log.append(f"FAILED {type(e).__name__}: {str(e)[:300]}")
        ok = False
    with open(os.path.join(out_dir, f"r{rank}.txt"), "w") as fh:
        fh.write("\n".join(log) + "\n")
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        pass
    if not ok:
        sys.exit(3)


def world(backend, n, mb):
    with tempfile.TemporaryDirectory() as td:
        store = os.path.join(td, "store")
        t0 = time.perf_counter()
        ctx = mp.start_processes(worker, args=(n, store, backend, mb, td),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.time() + 120
        res = "ok"
        try:
            while not ctx.join(timeout=max(1, deadline - time.time())):
                if time.time() > deadline:
                    res = "timeout"
                    break
        except Exception as e:  # noqa: BLE001
            res = f"exc {type(e).__name__}: {str(e).splitlines()[0][:200]}"
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        print(f"== {backend} x{n} ({mb} MiB): {res}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for r in range(n):
            f = os.path.join(td, f"r{r}.txt")
            if os.path.exists(f):
                for ln in open(f).read().splitlines():
                    print(f"  r{r}: {ln}", flush=True)


# ---------------------------------------------------------------------------
# pipeline: the sharded encode's lane chunks
# ---------------------------------------------------------------------------

def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _alone(iv, others):
    """Length of the union of ``iv`` not covered by ``others``."""
    total = 0
    cover = _union(others)
    for s, e in _union(iv):
        cut = sum(max(0, min(e, ce) - max(s, cs)) for cs, ce in cover)
        total += e - s - cut
    return total


def _device_ops(prof):
    """(name, start ns, end ns) of the card's operations in a profile,
    NCCL's annotations left out."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.name().startswith("nccl:")]


def _split_nccl(ops):
    nccl = [(s, e) for n, s, e in ops if n.startswith("ncclDevKernel")]
    rest = [(s, e) for n, s, e in ops if not n.startswith("ncclDevKernel")]
    return nccl, rest


def _ms(ns):
    return round(ns / 1e6, 4)


def _options(group, dev):
    """A coeff group's NCCL options as torch reports them (or why not)."""
    try:
        opts = group._get_backend(dev).options
        return {"high_priority": opts.is_high_priority_stream,
                "max_ctas": opts.config.max_ctas,
                "min_ctas": opts.config.min_ctas}
    except Exception as e:  # noqa: BLE001
        return f"{type(e).__name__}: {str(e)[:120]}"


class _Mesh:
    """The ('coeff', 'block') mesh ``m`` with another coeff group."""

    def __init__(self, m, group):
        self.shape, self._m, self._g = m.shape, m, group

    def get_group(self, name):
        return self._g if name == "coeff" else self._m.get_group(name)

    def get_local_rank(self, name):
        return self._m.get_local_rank(name)


def _variants(m, world, cuda):
    """(name, mesh) for the mesh itself and, on the card, meshes whose
    coeff group is a new NCCL group with options of its own."""
    yield "default", m
    if not cuda:
        return
    for name, high, ctas in (("normal_priority", False, None),
                             ("ctas16", True, 16)):
        try:
            opts = dist.ProcessGroupNCCL.Options()
            opts.is_high_priority_stream = high
            if ctas:
                opts.config.max_ctas = ctas
        except Exception as e:  # noqa: BLE001
            print(f"variant {name}: {type(e).__name__}: {e}", flush=True)
            continue
        yield name, _Mesh(m, dist.new_group(list(range(world)),
                                            pg_options=opts))


def pipeline_rank(rank, world, store, out_dir, dev_type):
    import contextlib
    import json
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from fastecc_tpu_torch import fields
    from fastecc_tpu_torch.parallel import _worker
    from fastecc_tpu_torch.parallel import mesh as pmesh
    from fastecc_tpu_torch.parallel import ntt_dist as nd

    cuda = dev_type == "cuda"
    dev = pmesh.init_process_group(rank, world, store, device=dev_type,
                                   timeout=600)
    m = pmesh.make_mesh(world, 1)
    group = m.get_group("coeff")
    field = fields.GF32
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # the four-card cell's stripe, or a small one on the CPU
    k, lanes = ((1 << 19, 8192) if cuda else (1 << 9, 256))
    small = 1 if cuda else 64       # shapes cut by this on the CPU
    res = {"rank": rank, "device": str(dev)}

    def fence():
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()

    def profiled(on):
        return (profile(activities=acts) if on and rank == 0
                else contextlib.nullcontext())

    # 1. one async all-to-all (1 GiB a rank) and K1 -> K3 enqueued after it
    send = torch.randint(0, 1 << 30, ((1 << 28) // small,),
                         dtype=torch.int32, device=dev)
    recv = torch.empty_like(send)
    y = _worker.seeded_u32(field.p, (512, 256, 2048 // small), 1, dev)
    for it in range(3):
        fence()
        with profiled(it == 2) as prof:
            w = dist.all_to_all_single(recv, send, group=group,
                                       async_op=True)
            nd._local_ntt(y, field, True)
            w.wait()
            fence()
    if rank == 0 and cuda:
        ops = _device_ops(prof)
        nccl, rest = _split_nccl(ops)
        res["overlap"] = {
            "ops": [[n[:60], _ms(s - ops[0][1]), _ms(e - ops[0][1])]
                    for n, s, e in sorted(ops, key=lambda o: o[1])],
            "nccl_ms": _ms(sum(e - s for s, e in _union(nccl))),
            "others_ms": _ms(sum(e - s for s, e in _union(rest))),
            "nccl_alone_ms": _ms(_alone(nccl, rest)),
        }
    del send, recv
    fence()

    # 2. K1 -> K3 a chunk's first and second transform by chunk width
    if rank == 0 and cuda:
        rate = {}
        for w in (128, 256, 512, 1024, 2048, 4096, 8192):
            for t, a in ((512, 256), (1024, 128)):
                x = _worker.seeded_u32(field.p, (t, a, w), 2, dev)
                for _ in range(2):
                    nd._local_ntt(x, field, True)
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                for _ in range(5):
                    nd._local_ntt(x, field, True)
                ev[1].record()
                torch.cuda.synchronize()
                ms = ev[0].elapsed_time(ev[1]) / 5
                rate[f"{t}x{a}x{w}"] = round(ms * 1e6 / x.numel(), 6)
                del x
                torch.cuda.empty_cache()
        res["ns_an_element"] = rate
    fence()

    # 3. the sharded encode at K chunks, on the mesh's coeff group (a
    # high-priority stream: init_process_group sets it) and on coeff groups
    # with other NCCL options (a normal-priority stream; NCCL's CTAs
    # capped, its share of the SMs beside the local steps)
    rows = k // world
    data = _worker.seeded_u32(field.p, (k, lanes), 3, dev, rank * rows,
                              (rank + 1) * rows)
    ref = None
    res["encode"] = {}
    res["coeff_options"] = _options(group, dev)
    for variant, vmesh in _variants(m, world, cuda):
        for chunks in (1, 4, 8, 16):
            nd.PIPE_CHUNKS, nd.PIPE_MIN_LANES = chunks, 1
            fence()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            nd.reset_collectives()
            out = nd.encode_parity_sharded(data, field, vmesh)
            fence()
            got = {"collectives": dict(nd.COLLECTIVES)}
            if cuda:
                got["peak_bytes"] = torch.cuda.max_memory_allocated()
                got["peak_over_inputs"] = got["peak_bytes"] - base
            if ref is None:
                ref = out
            got["same_bits"] = bool(torch.equal(out.view(torch.int32),
                                                ref.view(torch.int32)))
            del out
            walls = []
            for _ in range(6):
                fence()
                t0 = time.perf_counter()
                nd.encode_parity_sharded(data, field, vmesh)
                fence()
                walls.append((time.perf_counter() - t0) * 1e3)
            got["wall_ms"] = [round(v, 3) for v in walls]
            got["median_ms"] = round(statistics.median(walls), 3)
            fence()
            with profiled(True) as prof:
                nd.encode_parity_sharded(data, field, vmesh)
                fence()
            if rank == 0 and cuda:
                ops = _device_ops(prof)
                nccl, rest = _split_nccl(ops)
                got["trace"] = {
                    "busy_ms": _ms(sum(e - s for s, e in
                                       _union([(s, e) for _, s, e in ops]))),
                    "nccl_ms": _ms(sum(e - s for s, e in _union(nccl))),
                    "others_ms": _ms(sum(e - s for s, e in _union(rest))),
                    "nccl_alone_ms": _ms(_alone(nccl, rest)),
                    "span_ms": _ms(max(e for _, _, e in ops)
                                   - min(s for _, s, _ in ops)),
                }
                prof.export_chrome_trace(os.path.join(
                    "chiprun_out", f"pipeline_probe_{variant}_k{chunks}.json"))
            res["encode"][f"{variant}_k{chunks}"] = got
    del ref, data
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as fh:
        json.dump(res, fh)
    fence()
    dist.destroy_process_group()


def pipeline(dev_type):
    import json
    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        mp.start_processes(pipeline_rank,
                           args=(4, os.path.join(td, "store"), td, dev_type),
                           nprocs=4, start_method="spawn")
        reps = [json.load(open(os.path.join(td, f"r{r}.json")))
                for r in range(4)]
    out = {"wall_s": round(time.perf_counter() - t0, 1), "ranks": reps}
    if dev_type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout
    with open(os.path.join("chiprun_out", "pipeline_probe.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    r0 = reps[0]
    print(json.dumps({k: v for k, v in r0.items()
                      if k not in ("overlap", "encode")}), flush=True)
    if "overlap" in r0:
        print(json.dumps({k: v for k, v in r0["overlap"].items()
                          if k != "ops"}), flush=True)
        for op in r0["overlap"]["ops"]:
            print("  ", op, flush=True)
    for r in reps:
        print(r["rank"], {c: (e["same_bits"], e["median_ms"],
                              e.get("peak_bytes"))
                          for c, e in r["encode"].items()}, flush=True)
    for c, e in r0["encode"].items():
        print(c, e["median_ms"], e.get("trace"), flush=True)


if __name__ == "__main__":
    if DEV == "pipeline":
        pipeline(sys.argv[2] if len(sys.argv) > 2 else "cuda")
        sys.exit(0)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    if DEV == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout, flush=True)
        world("nccl", 1, 256)
        world("nccl", 2, 16)
    for ranks, mib in ((2, 256), (4, 256), (2, 1024)):
        world("gloo", ranks, mib if DEV == "cuda" else 16)
