"""``encode_blocks_gf32``: ``rs.encode_blocks`` on [k, B] raw bytes in the
GF32 wire format (a data block is W = B/4 little-endian words, each
w >= p stored as w - p, then ceil(W/16) lanes of escape bits; a parity
block is those W + ceil(W/16) lanes as little-endian u32 words, B + B/16
bytes at B = 4096); the traffic's ``pool`` stripes taken in turn. In
each stripe a share ``ff_share`` of the data blocks, rows drawn from the
seed, is all 0xFF, so every word of theirs is escaped."""

from __future__ import annotations

import torch

from fastecc_tpu_torch import rs

from . import (Operation, encode_multiplies, generator, lane_blocks,
               mismatches, shaped)
from ..reference import gf32_wire as wire
from ..reference import rs as ref


def field_lanes(words: int) -> int:
    """Lanes a data block of ``words`` words packs into."""
    return words + -(-words // 16)


class Op(Operation):
    def __init__(self, *args):
        super().__init__(*args)
        if self.name != "GF32" or self.block_bytes % 64:
            raise ValueError("encode_blocks_gf32 is judged in the GF32 wire "
                             "format, on blocks of whole 16-word groups")
        self.packed = field_lanes(self.lanes)

    def prepare(self) -> None:
        g = generator(self.seed, 1, self.device)
        ff = int(self.k * self.traffic["ff_share"])
        self.pool = []
        for _ in range(self.traffic["pool"]):
            raw = torch.randint(0, 256, (self.k, self.block_bytes),
                                dtype=torch.uint8, device=self.device,
                                generator=g)
            rows = torch.randperm(self.k, device=self.device, generator=g)
            raw[rows[:ff]] = 0xFF
            self.pool.append(raw)

    def call(self, i: int, entry):
        return entry("rs.encode_blocks", rs.encode_blocks,
                     self.pool[i % len(self.pool)], self.field, self.n)

    def judge(self, kept) -> list:
        bad, ok = shaped(kept, (self.n - self.k, 4 * self.packed),
                         torch.uint8)
        for s, raw in enumerate(self.pool):
            mine = [j for j in ok if kept[j][0] % len(self.pool) == s]
            if not mine:
                continue
            for cols, want in wire_blocks(self.ref, raw, self.n):
                for j in mine:
                    bad[j] += mismatches(kept[j][1][:, cols], want)
        return bad

    def operation_bytes(self) -> int:
        """k raw blocks read, n - k wire parity blocks written."""
        return self.k * self.block_bytes + (self.n - self.k) * 4 * self.packed

    def operation_multiplies(self) -> int:
        return self.packed * encode_multiplies(self.name, self.n, self.k)

    def pack_bytes(self) -> int:
        """What the pack must move: k raw blocks read, k blocks of field
        lanes written."""
        return self.k * self.block_bytes + self.k * 4 * self.packed


def wire_blocks(f: ref.Field, raw: torch.Tensor, n: int):
    """``f``'s wire parity of the [k, B] blocks ``raw``, in lane blocks of
    whole 16-word groups: for words [w0, w1), (the parity's stored bytes
    [4 w0, 4 w1), their bytes) and (its bitmap lanes' bytes
    [B + w0/4, B + w1/4), their bytes)."""
    k, b = raw.shape
    for w0, w1 in lane_blocks(b // 4, k, align=16):
        got = wire.gf32_wire(f.encode_parity(
            wire.gf32_words(raw[:, 4 * w0:4 * w1]), n))
        width = 4 * (w1 - w0)
        yield slice(4 * w0, 4 * w1), got[:, :width]
        yield slice(b + w0 // 4, b + w1 // 4), got[:, width:]


def control_encode_blocks(raw, field, n=None):
    k, b = raw.shape
    n = 2 * k if n is None else n
    out = torch.empty((n - k, 4 * field_lanes(b // 4)), dtype=torch.uint8,
                      device=raw.device)
    for cols, got in wire_blocks(ref.Field(field.name, control=True), raw,
                                 n):
        out[:, cols] = got
    return out


CONTROL = [(rs, "encode_blocks", control_encode_blocks)]
