"""Parallel codec on ``torch.distributed``: the mesh and the sharded
four-step NTT (the port's counterpart of ``parallel/``).

The mesh has two axes, as the reference's:

  * ``coeff`` shards the transform axis; the four-step's transposes are
    ``all_to_all_single`` exchanges over this axis's process group;
  * ``block`` shards the independent word lanes, with no communication.

Every rank is one process. The functions are SPMD: each takes this
rank's local shard and returns its local shard (``mesh.shard`` and
``mesh.gather`` move a global numpy array in and out). The local
transforms are the port's ``ntt.ntt_auto``: K1 -> K3 on the card, their
plain versions on the CPU. A world over the card uses NCCL when every
rank has a card of its own and Gloo when ranks share one (or run on the
CPU); ``mesh.init_process_group`` picks it.
"""

_NTT_DIST = ("ntt_sharded", "ntt_sharded_overlap", "encode_parity_sharded",
             "decode_sharded", "decode_prepared_sharded", "COLLECTIVES",
             "TABLE_MULS", "reset_collectives")
_MESH = ("make_mesh", "codeword_sharding", "replicated",
         "init_process_group", "shard", "gather")

__all__ = [*_MESH, *_NTT_DIST]


def __getattr__(name):
    """Lazy re-exports, so ``fastecc_tpu_torch.parallel.ntt_sharded`` works
    without importing the transform stack with the package."""
    if name in _NTT_DIST:
        from . import ntt_dist
        return getattr(ntt_dist, name)
    if name in _MESH:
        from . import mesh
        return getattr(mesh, name)
    raise AttributeError(
        f"module 'fastecc_tpu_torch.parallel' has no attribute {name!r}")
