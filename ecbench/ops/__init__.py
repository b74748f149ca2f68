"""The one traffic generator: a traffic mix is data, an operation a module.

A traffic file (``traffic/<mix>.json``) names an operation (``op``) and
its parameters; the configuration gives the field, n, k and the block
bytes. The operation is the module ``ops/<op>.py``, found by that name,
whose class ``Op`` (an :class:`Operation`):

* makes the inputs on the device from ``--seed`` (``prepare``);
* runs one call of the program (``call``) through the harness's
  ``entry``, which times and fences each program entry it is handed;
* may do the next call's work that is not timed (``before``);
* once the window has closed, judges the outputs the harness kept
  against the plain reference (``judge``: the words wrong in each);
* counts the least work a call needs (``operation_bytes``,
  ``operation_multiplies``), which the roofline readers hold against
  the card's peaks (``least_s``).

The module also names the program's entries it drives and the control
to put in their place (``CONTROL``, read by :mod:`ecbench.control`). So
an operation is added as a new file, and no file here changes.
"""

from __future__ import annotations

import importlib
import re

import numpy as np
import torch

from fastecc_tpu_torch.fields import FIELDS

from .. import peaks
from ..reference import rs as ref

WORD_BYTES = {"GF32": 4, "GF16": 2}
REF_BLOCK = 1 << 25         # int64 elements a reference block (256 MiB)
NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")

# The order up to which a root of unity multiplies without a multiply
# instruction: in GF(0xFFF00001) only -1; in GF(0x10001) 2 has order 32
# (2^16 = -1), so each power of two is a shift and a subtraction.
FREE_ORDER = {"GF32": 2, "GF16": 32}
# 32-bit multiply results a modular product takes at the least: GF32's
# needs the low and the high half of its 64-bit product (the reduction
# by 2^32 = 2^20 - 1 is shifts and adds); GF16's fits 32 bits.
PRODUCTS = {"GF32": 2, "GF16": 1}


def seed_state(seed: int, tag: int) -> int:
    """A 64-bit seed for stream ``tag`` of run ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64), tag])
    return int(ss.generate_state(1, np.uint64)[0])


def generator(seed: int, tag: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_state(seed, tag))
    return g


def random_u32(gen: torch.Generator, shape, high: int, device) -> torch.Tensor:
    """[rows, lanes] ``torch.uint32`` uniform in [0, high), made on the
    device in chunks of 2^24 values."""
    rows, lanes = shape
    out = torch.empty(shape, dtype=torch.int32, device=device)
    step = max(1, (1 << 24) // lanes)
    for r in range(0, rows, step):
        v = torch.randint(0, high, (min(step, rows - r), lanes),
                          dtype=torch.int64, device=device, generator=gen)
        out[r:r + step] = ref.i64_to_u32(v).view(torch.int32)
    return out.view(torch.uint32)


def lane_blocks(lanes: int, rows: int, align: int = 1):
    """[l0, l1) ranges that keep a reference block near REF_BLOCK."""
    width = max(align, REF_BLOCK // rows // align * align)
    return [(l0, min(l0 + width, lanes)) for l0 in range(0, lanes, width)]


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Words of ``got`` (u32 or uint8) that differ from int64 ``want``."""
    if got.dtype == torch.uint32:
        got = ref.u32_to_i64(got)
    return int((got.to(torch.int64) != want).sum().item())


def shaped(kept, shape, dtype):
    """Per kept output: all its words counted wrong unless it has the
    expected shape and type; and the indices of those that do."""
    ok = [j for j, (_, o) in enumerate(kept)
          if tuple(o.shape) == shape and o.dtype == dtype]
    return [0 if j in ok else shape[0] * shape[1]
            for j in range(len(kept))], ok


def transform_multiplies(size: int, free_order: int) -> int:
    """Twiddle multiplies of one radix-2 transform of ``size`` points,
    leaving out those by a root of order up to ``free_order``: the stage
    that joins h-point transforms into 2h-point ones multiplies by
    w_2h^j, j < h, in size/2h groups, and free_order/2 of those h roots
    are free (none of the stage's where 2h <= free_order)."""
    total, h = 0, 1
    while h < size:
        if 2 * h > free_order:
            total += size // (2 * h) * (h - free_order // 2)
        h *= 2
    return total


def encode_multiplies(name: str, n: int, k: int) -> int:
    """Multiplies of the encode a lane: the inverse transform of the k
    data words, then per coset of the n - k parity rows the shift (with
    1/k) and the forward transform."""
    t = transform_multiplies(k, FREE_ORDER[name])
    return t + (n // k - 1) * (k + t)


def module(op: str):
    """The module ``ops/<op>.py``."""
    if not NAME.match(op):
        raise ValueError(f"not an operation's name: {op!r}")
    return importlib.import_module(f"{__name__}.{op}")


def make(config: dict, traffic: dict, seed: int, device) -> "Operation":
    return module(traffic["op"]).Op(config, traffic, seed, device)


class Operation:
    """One cell's calls; see the module docstring."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.name = config["field"]
        self.field = FIELDS[self.name]
        self.ref = ref.Field(self.name)
        self.n, self.k = config["n"], config["k"]
        self.block_bytes = config["block_bytes"]
        self.lanes = self.block_bytes // WORD_BYTES[self.name]
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.high = min(self.ref.p, 1 << 8 * WORD_BYTES[self.name])
        # bytes of the codeword (data and parity blocks) a call serves
        self.codeword_bytes = self.n * self.block_bytes

    def before(self, i: int) -> None:
        """Work for call ``i`` outside its clock (none by default)."""

    def release(self) -> None:
        """Drop what the program made, before the reference runs."""

    def operation_bytes(self) -> int:
        raise NotImplementedError

    def operation_multiplies(self) -> int:
        raise NotImplementedError

    def least_s(self) -> dict:
        """The least seconds a call takes on the card by each bound: its
        bytes over the HBM's rate, its multiplies' 32-bit products over
        the integer multiply rate."""
        return {"bytes": self.operation_bytes() / peaks.HBM_BYTES_PER_S,
                "operations": self.operation_multiplies()
                * PRODUCTS[self.name] / peaks.INT32_MULS_PER_S}
