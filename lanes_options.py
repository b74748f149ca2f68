"""K12's layouts and lane tiles, measured on the card.

    python3 lanes_options.py

A developer's measurement, run from the repo's root on one NVIDIA GPU; no
entry point of the package uses it. K12 (``fastecc_tpu_torch/csrc/
lanes.cu`` ``pair_lanes_wire16_kernel``) runs the one-pass GF16 wire
pair. Each option is lanes.cu edited in a copy under
``build/lanes_options/`` and built alone with ``nvcc``:

  package   the half in the grid (block = (lane tile, half)), each element
            stored as its half's u16 of the stored word; the two-exchange
            split from 2^12 on with TL = 4 lanes a block (1024 threads),
            the one-exchange form held to two blocks an SM;
  tl2       the same with TL = 2 in the two-exchange form (512 threads,
            8-byte row segments);
  split11   the two-exchange split from 2^11 on (16 * 16 * 8 there);
  lb_none   no minimum of blocks an SM anywhere (the one-argument
            __launch_bounds__: ptxas' own register choice);
  seq16     both halves in one block, one after the other (the tile copied
            in again for hi, from L2), u16 stores;
  parked    both halves in one block, lo's result parked in registers while
            hi runs, then whole stored words and both halves' escape bits.

Each is held equal to the package's K12 at every k = 4 .. 2^13 over Wu =
8, 40 and 1024 and on dense escapes at k = 32 and 2^13, then timed in
turns (CUDA events, chip_smoke.event_ms) on 128 MiB of pairs at k = 2^10
.. 2^13 and at the GF16 wire encode's [2^13, 16384]. Prints ptxas'
registers and spills of every K12 instantiation.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from fastecc_tpu_torch.fields import GF16
from fastecc_tpu_torch.kernels import _build
from fastecc_tpu_torch.kernels import ntt_mfa as m

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "lanes_options"
KERNEL_START = "// K12: block = (lane tile, half), the half the fastest index"
KERNEL_END = "template <int LA>\ncudaError_t launch_wire16("
GRID = "const unsigned blocks = 2u * (unsigned)"

ONE_BLOCK = r'''
// K12 with both halves in one block: lo, then hi after the tile is copied
// in again; the option gives each half's epilogue.
template <int LA>
__global__ void __launch_bounds__(Wire16Shape<LA>::kThreads,
                                  Wire16Shape<LA>::kMinBlocks)
    pair_lanes_wire16_kernel(Wire16Args p) {
  using W = Wire16Shape<LA>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int l0 = blockIdx.x * W::TL;
  const int lane = l0 + threadIdx.x % W::TL;
  const bool live = lane < p.L;
  uint32_t* bm = p.bitmap + (lane >> 3);
  const int sh = 2 * (lane & 7);
  const int words = p.L >> 3;
  uint32_t park[W::Inner::A1];
  (void)park;
  load_block<LA>(smem, p, l0);
  pair_half<LA>(p, smem, 0, live, [&](auto i, uint32_t v, int row) {
    STORE_LO
  });
  __syncthreads();
  load_block<LA>(smem, p, l0);
  pair_half<LA>(p, smem, 1, live, [&](auto i, uint32_t v, int row) {
    STORE_HI
  });
}

'''
SEQ16_LO = '''p.stored[2 * ((size_t)row * p.L + lane)] = (uint16_t)v;
    if (v >> 16) atomicOr(bm + (size_t)row * words, 1u << sh);'''
SEQ16_HI = '''p.stored[2 * ((size_t)row * p.L + lane) + 1] = (uint16_t)v;
    if (v >> 16) atomicOr(bm + (size_t)row * words, 2u << sh);'''
PARKED_LO = '''(void)row;
    park[decltype(i)::value] = v;'''
PARKED_HI = '''const uint32_t lo = park[decltype(i)::value];
    ((uint32_t*)p.stored)[(size_t)row * p.L + lane] = (lo & 0xFFFFu) | (v << 16);
    const uint32_t bits = ((lo >> 16) | (v >> 16) << 1) << sh;
    if (bits) atomicOr(bm + (size_t)row * words, bits);'''


# tl2's tile load: 8-byte row segments, so 4-byte copies
LOAD_TILE = """  static_assert(S::TL >= 4, "16-byte copies need row segments of 4 lanes");
  fecc::load_tile_async<S>(smem, p.x, 1, p.L, 0, l0, p.vec != 0);"""
LOAD_PAIRS = """  if constexpr (S::TL < 4) {
    fecc::static_for<S::A * S::TL / S::kThreads>([&](auto i) {
      const int e = threadIdx.x + decltype(i)::value * S::kThreads;
      const int a = e / S::TL, l = e % S::TL;
      const bool in = l0 + l < p.L;
      fecc::cp_async4(smem + e, in ? p.x + (size_t)a * p.L + l0 + l : p.x,
                      in ? 4 : 0);
    });
  } else {
    fecc::load_tile_async<S>(smem, p.x, 1, p.L, 0, l0, p.vec != 0);
  }"""


def edit(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, old
    return src.replace(old, new)


def one_block(lo: str, hi: str):
    def f(src: str) -> str:
        a, b = src.index(KERNEL_START), src.index(KERNEL_END)
        body = ONE_BLOCK.replace("STORE_LO", lo).replace("STORE_HI", hi)
        return edit(src[:a] + body + src[b:], GRID,
                    GRID.replace("2u *", "1u *"))
    return f


VARIANTS = {
    "package": lambda s: s,
    "tl2": lambda s: edit(edit(s, "constexpr int kTwoExchangeTL = 4;",
                               "constexpr int kTwoExchangeTL = 2;"),
                          LOAD_TILE, LOAD_PAIRS),
    "split11": lambda s: edit(s, "constexpr int kTwoExchangeLog = 12;",
                              "constexpr int kTwoExchangeLog = 11;"),
    "lb_none": lambda s: edit(s, "__launch_bounds__(Wire16Shape<LA>::kThreads,\n"
                              "                                  "
                              "Wire16Shape<LA>::kMinBlocks)\n"
                              "    pair_lanes_wire16_kernel",
                              "__launch_bounds__(Wire16Shape<LA>::kThreads)\n"
                              "    pair_lanes_wire16_kernel"),
    "seq16": one_block(SEQ16_LO, SEQ16_HI),
    "parked": one_block(PARKED_LO, PARKED_HI),
}
TWO_EXCHANGE_LOG = {"split11": 11}


def ptxas(log: str, tag: str) -> None:
    name = None
    for line in log.splitlines():
        mm = re.search(r"Compiling entry function '(\S+)'", line)
        if mm:
            name = mm.group(1)
            continue
        km = name and re.search(r"pair_lanes_wire16_kernelILi(\d+)E", name)
        if km and ("Used" in line or "spill" in line):
            cs.say(f"[{tag}] LA{km.group(1)}: "
                   f"{line.split(':', 1)[-1].strip()}")


def build_variants() -> dict:
    """{name: library}, each variant's lanes.cu built alone."""
    src = (ROOT / "fastecc_tpu_torch" / "csrc" / "lanes.cu").read_text()
    procs = {}
    for name, fn in VARIANTS.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "fastecc_tpu_torch" / "csrc", d)
        (d / "lanes.cu").write_text(fn(src))
        procs[name] = (d, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "lanes.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"{name} build:\n{log[-4000:]}")
        ptxas(log, name)
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.fecc_pair_lanes_wire16
        fn.argtypes = _build.SIGNATURES["fecc_pair_lanes_wire16"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def tables(k: int, g: int, two_log: int, dev: str) -> list:
    """K12's tables for a split that takes two exchanges from 2^two_log on
    (the package's: kernels/ntt_mfa.py _lanes16_tables_on)."""
    la = k.bit_length() - 1
    if la < two_log:
        b1, a, a1 = 0, k, m._row_split(k)[0]
    else:
        b1 = 1 << -(-la // 3)
        a, a1 = k // b1, b1
    lvl = [m._u32_on(np.ascontiguousarray(
        m._split_twiddles(GF16.name, k, b1, inv).T if inv else
        m._split_twiddles(GF16.name, k, b1, inv)), dev) if b1 else None
        for inv in (True, False)]
    inner = [m._u32_on(m._split_twiddles(GF16.name, a, a1, inv), dev)
             for inv in (True, False)]
    return [*lvl, *inner, m._mid_on(GF16.name, k, g % GF16.p, dev)]


def launcher(name: str, lib, x: torch.Tensor, g: int):
    k, wu = x.shape
    tabs = tables(k, g, TWO_EXCHANGE_LOG.get(name, m._log2(
        m.LANES16_TWO_EXCHANGE_K)), str(x.device))
    stored = torch.empty_like(x)
    bitmap = torch.empty((k, wu // 8), dtype=torch.uint32, device=x.device)

    def call():
        code = lib.fecc_pair_lanes_wire16(
            1, x.data_ptr(), stored.data_ptr(), bitmap.data_ptr(), k, wu,
            *(None if t is None else t.data_ptr() for t in tabs),
            torch.cuda.current_stream().cuda_stream)
        cs.check(code == 0, f"{name}: fecc_pair_lanes_wire16 returned {code}")
        return stored, bitmap
    return call


def pairs(k: int, wu: int, gen) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, (k, wu), dtype=torch.int32,
                         device="cuda", generator=gen).view(torch.uint32)


def main() -> int:
    if not torch.cuda.is_available():
        print("lanes_options: no CUDA device", file=sys.stderr)
        return 2
    cs.say(cs.card_line())
    b = _build.build()
    ptxas(b.log, "package (the package's build)")
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(11)
    for la in range(2, 14):
        k = 1 << la
        g = GF16.root_of_order(2 * k)
        cases = [pairs(k, wu, gen) for wu in (8, 40, 1024)]
        if k in (32, 1 << 13):
            cases.append(cs.dense_escape_pairs(k, 40, g, gen))
        for x in cases:
            want = m.ntt_pair_lanes_wire16(x, GF16, g)
            for name, lib in libs.items():
                cs.check(cs.same(launcher(name, lib, x, g)(), want),
                         f"{name} != the package at k = {k}, "
                         f"Wu = {x.shape[1]}")
    cs.say(f"[lanes_options] {sorted(libs)} == the package's K12 at every "
           f"k = 4 .. 2^13 over Wu = 8, 40, 1024 and on dense escapes")
    for k, wu in ((1 << 10, 1 << 15), (1 << 11, 1 << 14), (1 << 12, 1 << 13),
                  (1 << 13, 1 << 12), (1 << 13, 1 << 14)):
        g = GF16.root_of_order(2 * k)
        x = pairs(k, wu, gen)
        fns = {name: launcher(name, lib, x, g) for name, lib in libs.items()}
        order = list(fns)
        ms = {}
        for name in order + order[::-1]:
            ms.setdefault(name, []).append(cs.event_ms(fns[name]))
        cs.say(f"[lanes_options] [{k}, {wu}] pairs, ms in turns {order} then "
               f"back: " + "; ".join(f"{n} {t[0]:.4f} / {t[1]:.4f}"
                                     for n, t in ms.items()))
        del x, fns
    return 0


if __name__ == "__main__":
    sys.exit(main())
