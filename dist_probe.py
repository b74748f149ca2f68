"""What torch.distributed offers on the card(s) of the machine it runs
on, for the sharded codec (fastecc_tpu_torch.parallel):

    python3 dist_probe.py          # on a machine with a card
    python3 dist_probe.py cpu      # Gloo worlds on the CPU only

Starts worlds of 1, 2 and 4 ranks (spawned processes, a file:// store) and
prints, per rank: whether all_to_all_single takes int32 and uint32
tensors, whether the async form, all_gather and a ('coeff', 'block')
DeviceMesh's coeff group work, and the time of an all_to_all_single of
256 MiB or 1 GiB a rank (GiB a second moved to other ranks), after one
untimed call. On the card it also tries NCCL with two ranks on one GPU
(which NCCL refuses) and with one rank.
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


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    if DEV == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout, flush=True)
        world("nccl", 1, 256)
        world("nccl", 2, 16)
    for ranks, mib in ((2, 256), (4, 256), (2, 1024)):
        world("gloo", ranks, mib if DEV == "cuda" else 16)
