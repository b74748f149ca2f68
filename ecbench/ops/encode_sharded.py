"""``encode_sharded``: ``parallel.encode_parity_sharded`` on a mesh of D x 1
ranks (the traffic's ``mesh``), one process a card. Rank r holds rows
[r k/D, (r+1) k/D) of each of the ``pool`` stripes, taken in turn, and
its call returns its [(n - k)/D, L] share of ``rs.encode_parity``'s rows.

Every rank makes its own rows from the seed: a stripe's rows come in
chunks, each from a generator of its own (:meth:`Op.rows`), so the global
stripe is the same on any number of ranks. The judge gives rank r the
whole parity of lanes [r L/D, (r+1) L/D): each kept output's columns move
to their rank over the harness's own group (``World.exchange``), and the
plain reference encodes those lanes of the stripe, made again from the
seed. So each rank's reference work is 1/D of the stripe's."""

from __future__ import annotations

import torch

from fastecc_tpu_torch import parallel
from fastecc_tpu_torch.parallel import ntt_dist

from . import (Operation, encode_multiplies, generator, lane_blocks,
               mismatches)
from .. import peaks
from ..reference import rs as ref

CHUNK = 1 << 24          # values a generator draws: one chunk of rows
EXCHANGE_BYTES = 1 << 28  # the judge moves outputs in pieces of this size
NOT_A_WORD = -1          # 0xFFFFFFFF, above every residue


class Op(Operation):
    def __init__(self, *args):
        super().__init__(*args)
        if self.world is None:
            raise ValueError("encode_sharded runs on a world of ranks")
        self.d, block = self.traffic["mesh"]
        if block != 1 or self.d != self.world.size:
            raise ValueError(f"mesh {self.traffic['mesh']} is not "
                             f"{self.world.size} x 1")
        if self.k % self.d or self.lanes % self.d:
            raise ValueError(f"k = {self.k} and {self.lanes} lanes do not "
                             f"split over {self.d} ranks")
        self.parity_rows = (self.n - self.k) // self.d

    def rows(self, s: int, r0: int, r1: int, l0: int, l1: int):
        """Rows [r0, r1) and lanes [l0, l1) of stripe ``s`` of the global
        [k, L] data, u32 words below p, on the device. Chunk c of the
        stripe's rows is drawn whole by its own generator (seeded from
        the seed, s and c), so any rank draws any rows alone."""
        per = max(1, CHUNK // self.lanes)
        out = torch.empty((r1 - r0, l1 - l0), dtype=torch.int32,
                          device=self.device)
        for c in range(r0 // per, -(-r1 // per)):
            c0, c1 = c * per, min((c + 1) * per, self.k)
            g = generator(self.seed, (s + 1) << 32 | c, self.device)
            v = torch.randint(0, self.high, (c1 - c0, self.lanes),
                              dtype=torch.int64, device=self.device,
                              generator=g)
            a, b = max(r0, c0), min(r1, c1)
            out[a - r0:b - r0] = ref.i64_to_u32(
                v[a - c0:b - c0, l0:l1]).view(torch.int32)
        return out.view(torch.uint32)

    def prepare(self) -> None:
        w = self.world
        dev = parallel.init_process_group(w.rank, w.size, w.store,
                                          device=self.device,
                                          timeout=w.timeout)
        if dev != self.device:
            raise RuntimeError(f"rank {w.rank} is on {self.device}, the "
                               f"program put it on {dev}")
        self.mesh = parallel.make_mesh(self.d, 1)
        rows = self.k // self.d
        r0 = self.mesh.get_local_rank("coeff") * rows
        self.pool = [self.rows(s, r0, r0 + rows, 0, self.lanes)
                     for s in range(self.traffic["pool"])]

    def call(self, i: int, entry):
        return entry("parallel.encode_parity_sharded",
                     parallel.encode_parity_sharded,
                     self.pool[i % len(self.pool)], self.field, self.mesh,
                     self.n)

    def release(self) -> None:
        import torch.distributed as dist
        self.pool = self.mesh = None
        dist.destroy_process_group()

    def my_lanes(self, out) -> torch.Tensor:
        """The whole parity's [n - k, L/D] of this rank's lanes, from every
        rank's rows of one kept output (a rank whose output has not the
        expected shape and type sends NOT_A_WORD in its place)."""
        d, rows, lanes = self.d, self.parity_rows, self.lanes
        lb = lanes // d
        if tuple(out.shape) == (rows, lanes) and out.dtype == torch.uint32:
            mine = out.view(torch.int32)
        else:
            mine = torch.full((rows, lanes), NOT_A_WORD, dtype=torch.int32,
                              device=self.device)
        got = torch.empty((d, rows, lb), dtype=torch.int32,
                          device=self.device)
        step = max(1, EXCHANGE_BYTES // (4 * lanes))
        for r0 in range(0, rows, step):
            piece = mine[r0:r0 + step].reshape(-1, d, lb).movedim(1, 0)
            got[:, r0:r0 + step] = self.world.exchange(piece.contiguous())
        return got.reshape(d * rows, lb).view(torch.uint32)

    def judge(self, kept) -> list:
        lb = self.lanes // self.d
        first = self.world.rank * lb
        cols = [self.my_lanes(out) for _, out in kept]
        bad = [0] * len(kept)
        pool = self.traffic["pool"]
        for s in range(pool):
            mine = [j for j, (i, _) in enumerate(kept) if i % pool == s]
            if not mine:
                continue
            data = self.rows(s, 0, self.k, first, first + lb)
            for l0, l1 in lane_blocks(lb, self.k):
                want = self.ref.encode_parity(
                    ref.u32_to_i64(data[:, l0:l1]), self.n)
                for j in mine:
                    bad[j] += mismatches(cols[j][:, l0:l1], want)
        return bad

    def operation_bytes(self) -> int:
        """This rank's k/D data blocks read, its (n - k)/D parity blocks
        written."""
        return self.n // self.d * self.block_bytes

    def operation_multiplies(self) -> int:
        """This rank's share of the encode's multiplies."""
        return self.lanes * encode_multiplies(self.name, self.n,
                                              self.k) // self.d

    def link_bytes(self) -> int:
        """Bytes this rank has to send to other cards a call: one
        all-to-all a transform (the inverse one, and a forward one a
        coset), the fewest a four-step transform with a transposed end
        needs, each sending (D - 1)/D of the rank's k/D rows."""
        transforms = self.n // self.k
        return (transforms * (self.d - 1) * (self.k // self.d)
                * self.block_bytes // self.d)

    def least_s(self) -> dict:
        least = super().least_s()
        least["link"] = self.link_bytes() / peaks.LINK_BYTES_PER_S
        return least


def control_encode_parity_sharded(data, field, mesh, n=None):
    """The reference in the program's place, every product rounded to
    float64 (float32 in GF16): the world's rows go to every rank by lanes
    over the mesh's own group, each rank encodes the whole stripe's
    parity of its 1/D of the lanes, and the rows go back."""
    import torch.distributed as dist
    d = mesh.shape[0]
    group = mesh.get_group("coeff")
    rows, lanes = data.shape
    k = rows * d
    n = 2 * k if n is None else n
    lb = lanes // d

    def swap(t):
        t = t.contiguous()
        recv = torch.empty_like(t)
        dist.all_to_all_single(recv, t, group=group)
        return recv

    cols = swap(data.view(torch.int32).reshape(rows, d, lb).movedim(1, 0))
    mine = cols.reshape(k, lb).view(torch.uint32)
    f = ref.Field(field.name, control=True)
    par = torch.empty((n - k, lb), dtype=torch.int32, device=data.device)
    for l0, l1 in lane_blocks(lb, k):
        par[:, l0:l1] = ref.i64_to_u32(f.encode_parity(
            ref.u32_to_i64(mine[:, l0:l1]), n)).view(torch.int32)
    back = swap(par.reshape(d, (n - k) // d, lb))
    return back.movedim(0, 1).reshape((n - k) // d, lanes).view(torch.uint32)


CONTROL = [(ntt_dist, "encode_parity_sharded", control_encode_parity_sharded)]
