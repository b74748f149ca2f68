"""``decode``: ``decode.decode_prepared`` on a codeword [n, L] that lost
``lost_share`` of its n blocks, the lost rows filled with garbage drawn
from the seed. One loss pattern is drawn from the seed and its tables
built (``decode.prepare_decode_tables``) in set-up, as a storage node
does once a device has died; every call decodes with them."""

from __future__ import annotations

import torch

from fastecc_tpu_torch import decode, rs

from . import (FREE_ORDER, Operation, generator, lane_blocks, mismatches,
               random_u32, shaped, transform_multiplies)
from ..reference import rs as ref


class Op(Operation):
    def __init__(self, *args):
        super().__init__(*args)
        self.lost = int(self.n * self.traffic["lost_share"])
        if not 1 <= self.lost <= self.n - self.k:
            raise ValueError(f"cannot recover {self.lost} lost blocks of "
                             f"{self.n} with k = {self.k}")

    def prepare(self) -> None:
        dev = self.device
        self.data = random_u32(generator(self.seed, 1, dev),
                               (self.k, self.lanes), self.high, dev)
        garbage = random_u32(generator(self.seed, 2, dev),
                             (self.lost, self.lanes), self.high, dev)
        # the program's own encode makes the stripe it will decode; the
        # judge holds the result to the reference encode of the data
        self.x = rs.encode(self.data, self.field, self.n)
        idx = torch.randperm(self.n, device=dev,
                             generator=generator(self.seed, 3, dev))
        idx = idx[:self.lost]
        self.x.view(torch.int32).index_copy_(0, idx,
                                             garbage.view(torch.int32))
        self.tables = decode.prepare_decode_tables(
            idx.cpu().numpy(), self.n, self.field, device=dev)

    def call(self, i: int, entry):
        return entry("decode.decode_prepared", decode.decode_prepared,
                     self.x, *self.tables, self.field)

    def release(self) -> None:
        self.x = self.tables = None

    def judge(self, kept) -> list:
        bad, ok = shaped(kept, (self.n, self.lanes), torch.uint32)
        if ok:
            for l0, l1 in lane_blocks(self.lanes, self.n):
                want = self.ref.codeword(ref.u32_to_i64(
                    self.data[:, l0:l1]), self.n)
                for j in ok:
                    bad[j] += mismatches(kept[j][1][:, l0:l1], want)
        return bad

    def operation_bytes(self) -> int:
        """The surviving blocks read, the lost ones written: an
        implementation may hand back the survivors where they lie."""
        return self.n * self.block_bytes

    def operation_multiplies(self) -> int:
        """A lane: the inverse transform of c l(w^j) and the forward one
        of x h'(x), each of n points, with the n multiplies by i that
        form the derivative and one at each row by l(w^j) (survivors) or
        by the Forney inverse (lost rows)."""
        t = transform_multiplies(self.n, FREE_ORDER[self.name])
        return self.lanes * (2 * t + 2 * self.n)


def control_prepare_decode_tables(erased_idx, n, field, device=None):
    idx = torch.as_tensor(erased_idx, dtype=torch.int64).to(device)
    f = ref.Field(field.name, control=True)
    return idx, f.decode_tables(idx, n), None


def control_decode_prepared(codeword, idx, tables, _, field):
    n, lanes = codeword.shape
    f = ref.Field(field.name, control=True)
    out = torch.empty_like(codeword)
    for l0, l1 in lane_blocks(lanes, n):
        rec = f.decode(ref.u32_to_i64(codeword[:, l0:l1]), idx, tables)
        out[:, l0:l1] = ref.i64_to_u32(rec)
    return out


CONTROL = [(decode, "prepare_decode_tables", control_prepare_decode_tables),
           (decode, "decode_prepared", control_decode_prepared)]
