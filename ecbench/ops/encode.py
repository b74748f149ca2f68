"""``encode``: ``rs.encode_parity`` on [k, L] field elements, L words a
block; the traffic's ``pool`` stripes taken in turn."""

from __future__ import annotations

import torch

from fastecc_tpu_torch import rs

from . import (Operation, encode_multiplies, generator, lane_blocks,
               mismatches, random_u32, shaped)
from ..reference import rs as ref


class Op(Operation):
    def prepare(self) -> None:
        g = generator(self.seed, 1, self.device)
        self.pool = [random_u32(g, (self.k, self.lanes), self.high,
                                self.device)
                     for _ in range(self.traffic["pool"])]

    def call(self, i: int, entry):
        return entry("rs.encode_parity", rs.encode_parity,
                     self.pool[i % len(self.pool)], self.field, self.n)

    def judge(self, kept) -> list:
        bad, ok = shaped(kept, (self.n - self.k, self.lanes), torch.uint32)
        for s, data in enumerate(self.pool):
            mine = [j for j in ok if kept[j][0] % len(self.pool) == s]
            if not mine:
                continue
            for l0, l1 in lane_blocks(self.lanes, self.k):
                want = self.ref.encode_parity(
                    ref.u32_to_i64(data[:, l0:l1]), self.n)
                for j in mine:
                    bad[j] += mismatches(kept[j][1][:, l0:l1], want)
        return bad

    def operation_bytes(self) -> int:
        """k data blocks read, n - k parity blocks written."""
        return self.n * self.block_bytes

    def operation_multiplies(self) -> int:
        return self.lanes * encode_multiplies(self.name, self.n, self.k)


def control_encode_parity(data, field, n=None):
    k, lanes = data.shape
    n = 2 * k if n is None else n
    f = ref.Field(field.name, control=True)
    out = torch.empty((n - k, lanes), dtype=torch.uint32, device=data.device)
    for l0, l1 in lane_blocks(lanes, k):
        par = f.encode_parity(ref.u32_to_i64(data[:, l0:l1]), n)
        out[:, l0:l1] = ref.i64_to_u32(par)
    return out


CONTROL = [(rs, "encode_parity", control_encode_parity)]
