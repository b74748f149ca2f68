"""The process group and the ('coeff', 'block') mesh (the port's
counterpart of ``parallel/mesh.py``).

Axis convention (see the package docstring): the all-to-all traffic of
the sharded four-step rides ``coeff``; ``block`` carries none. Rank r sits
at (r // n_block, r % n_block), the reference's device order.

Where the reference gets its processes from ``jax.distributed`` and its
data layout from ``NamedSharding``, here :func:`init_process_group` joins
this process to a world over a file rendezvous and :func:`shard` /
:func:`gather` move a global numpy array to this rank's local tensor and
back (for tests and the CLI; no timed path uses them).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# This rank's device, set by init_process_group.
_RANK_DEVICE: torch.device | None = None


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def backend_for(device: torch.device, world_size: int) -> str:
    """NCCL when every rank has a card of its own; Gloo when ranks share
    a card or run on the CPU (NCCL refuses two ranks of one communicator
    on one GPU). The local transforms launch the same kernels either
    way."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_process_group(rank: int, world_size: int, store_path,
                       device=None, timeout: float = 300.0) -> torch.device:
    """Join this process to a world of ``world_size`` ranks over a
    ``file://`` rendezvous at ``store_path`` and return the rank's device:
    ``cuda:{local_rank % device_count}`` unless ``device`` is the CPU
    (``interop.resolve_device`` raises without a GPU). ``timeout`` (s)
    bounds every collective, so a rank stuck in one fails."""
    global _RANK_DEVICE
    from ..interop import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend_for(dev, world_size)
    dist.init_process_group(
        backend, init_method=f"file://{store_path}", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout),
        device_id=dev if backend == "nccl" else None)
    _RANK_DEVICE = dev
    return dev


def rank_device() -> torch.device:
    """The device :func:`init_process_group` gave this rank."""
    if _RANK_DEVICE is None:
        raise RuntimeError("call parallel.init_process_group first")
    return _RANK_DEVICE


def make_mesh(n_coeff: int | None = None, n_block: int | None = None,
              device=None):
    """The ('coeff', 'block') ``DeviceMesh`` over the initialised world.

    Defaults as the reference's: the largest power of two, all of it on
    ``coeff`` unless ``n_block`` is given. The mesh must cover the whole
    world: one larger or smaller raises ``ValueError``."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("call parallel.init_process_group first")
    n = dist.get_world_size()
    if n_coeff is None and n_block is None:
        n_coeff, n_block = _pow2_floor(n), 1
    elif n_coeff is None:
        n_coeff = _pow2_floor(n) // n_block
    elif n_block is None:
        n_block = _pow2_floor(n) // n_coeff
    if n_coeff < 1 or n_block < 1 or n_coeff * n_block != n:
        raise ValueError(f"mesh {n_coeff}x{n_block} needs "
                         f"{n_coeff * n_block} ranks; the world has {n} "
                         f"(a mesh covers the whole world)")
    dev = torch.device(device) if device is not None else rank_device()
    return DeviceMesh(dev.type, torch.arange(n).reshape(n_coeff, n_block),
                      mesh_dim_names=("coeff", "block"))


def codeword_sharding(mesh):
    """Placements of [N, L] codec arrays: the transform axis on 'coeff',
    the word lanes on 'block'."""
    from torch.distributed.tensor import Shard
    return (Shard(0), Shard(1))


def replicated(mesh):
    from torch.distributed.tensor import Replicate
    return (Replicate(), Replicate())


def coords(mesh) -> tuple[int, int]:
    """This rank's (coeff, block) index."""
    return mesh.get_local_rank("coeff"), mesh.get_local_rank("block")


def _block(shape, mesh, ci: int, bi: int, transposed: bool):
    """Index of rank (ci, bi)'s shard in a global array of ``shape``:
    natural [N, ..., L] by rows and lanes ([N] vectors by rows only),
    transposed [R, C, L] by its middle axis and lanes."""
    dc, db = mesh.shape
    ax = 1 if transposed else 0
    if shape[ax] % dc or (len(shape) > 1 and shape[-1] % db):
        raise ValueError(f"{tuple(shape)} does not split over a "
                         f"{dc}x{db} mesh")
    rows = shape[ax] // dc
    idx = [slice(None)] * len(shape)
    idx[ax] = slice(ci * rows, (ci + 1) * rows)
    if len(shape) > 1:
        lanes = shape[-1] // db
        idx[-1] = slice(bi * lanes, (bi + 1) * lanes)
    return tuple(idx)


def shard(x, mesh, transposed: bool = False, device=None) -> torch.Tensor:
    """This rank's local shard of the global numpy array ``x`` (u32 as
    ``torch.uint32``) on ``device`` (default: the rank's)."""
    from ..interop import as_tensor
    x = np.asarray(x)
    part = x[_block(x.shape, mesh, *coords(mesh), transposed)]
    return as_tensor(np.ascontiguousarray(part),
                     device if device is not None else rank_device())


def gather(local: torch.Tensor, mesh, transposed: bool = False
           ) -> np.ndarray:
    """The global numpy array from every rank's local shard (the inverse
    of :func:`shard`), on every rank."""
    dc, db = mesh.shape
    is_u32 = local.dtype == torch.uint32
    t = (local.view(torch.int32) if is_u32 else local).contiguous()
    if dist.get_backend() == "gloo":
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(dc * db)]
    dist.all_gather(parts, t)
    shape = list(t.shape)
    shape[1 if transposed else 0] *= dc
    if len(shape) > 1:
        shape[-1] *= db
    out = np.empty(shape, dtype=parts[0].cpu().numpy().dtype)
    for r, part in enumerate(parts):
        out[_block(shape, mesh, r // db, r % db, transposed)] = (
            part.cpu().numpy())
    return out.view(np.uint32) if is_u32 else out
