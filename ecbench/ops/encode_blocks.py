"""``encode_blocks``: ``rs.encode_blocks`` on [k, B] random bytes in the
GF16 wire format (a parity block is B + B/16 bytes: B/2 little-endian
words, 0x10000 stored as 0, then a bit a word marking it); the
traffic's ``pool`` stripes taken in turn."""

from __future__ import annotations

import torch

from fastecc_tpu_torch import rs

from . import (Operation, encode_multiplies, generator, lane_blocks,
               mismatches, shaped)
from ..reference import rs as ref


class Op(Operation):
    def __init__(self, *args):
        super().__init__(*args)
        if self.name != "GF16" or self.n != 2 * self.k:
            raise ValueError("encode_blocks is judged in the GF16 wire "
                             "format at rate 1/2")

    def prepare(self) -> None:
        g = generator(self.seed, 1, self.device)
        self.pool = [torch.randint(0, 256, (self.k, self.block_bytes),
                                   dtype=torch.uint8, device=self.device,
                                   generator=g)
                     for _ in range(self.traffic["pool"])]

    def call(self, i: int, entry):
        return entry("rs.encode_blocks", rs.encode_blocks,
                     self.pool[i % len(self.pool)], self.field, self.n)

    def judge(self, kept) -> list:
        b = self.block_bytes
        bad, ok = shaped(kept, (self.n - self.k, b + b // 16), torch.uint8)
        for s, raw in enumerate(self.pool):
            mine = [j for j in ok if kept[j][0] % len(self.pool) == s]
            if not mine:
                continue
            # words [w0, w1): stored bytes [2 w0, 2 w1), escape bits
            # [b + w0/8, b + w1/8)
            for w0, w1 in lane_blocks(self.lanes, self.k, align=16):
                words = ref.gf16_words(raw[:, 2 * w0:2 * w1])
                want = ref.gf16_wire(self.ref.encode_parity(words, self.n))
                width = 2 * (w1 - w0)
                for j in mine:
                    out = kept[j][1]
                    bad[j] += mismatches(out[:, 2 * w0:2 * w1],
                                         want[:, :width])
                    bad[j] += mismatches(out[:, b + w0 // 8:b + w1 // 8],
                                         want[:, width:])
        return bad

    def operation_bytes(self) -> int:
        """k raw blocks read, n - k wire parity blocks written."""
        b = self.block_bytes
        return self.k * b + (self.n - self.k) * (b + b // 16)

    def operation_multiplies(self) -> int:
        return self.lanes * encode_multiplies(self.name, self.n, self.k)


def control_encode_blocks(raw, field, n=None):
    k, b = raw.shape
    n = 2 * k if n is None else n
    f = ref.Field(field.name, control=True)
    out = torch.empty((n - k, b + b // 16), dtype=torch.uint8,
                      device=raw.device)
    for w0, w1 in lane_blocks(b // 2, k, align=16):
        wire = ref.gf16_wire(f.encode_parity(
            ref.gf16_words(raw[:, 2 * w0:2 * w1]), n))
        width = 2 * (w1 - w0)
        out[:, 2 * w0:2 * w1] = wire[:, :width]
        out[:, b + w0 // 8:b + w1 // 8] = wire[:, width:]
    return out


CONTROL = [(rs, "encode_blocks", control_encode_blocks)]
