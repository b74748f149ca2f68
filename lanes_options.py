"""The lanes kernels' layouts, splits, bounds and lane tiles, measured on
the card.

    python3 lanes_options.py [k11] [k12]

A developer's measurement, run from the repo's root on one NVIDIA GPU; no
entry point of the package uses it. K11 (``fastecc_tpu_torch/csrc/
lanes.cu`` ``pair_lanes_kernel``, GF32 and GF16) and K12
(``pair_lanes_wire16_kernel``) run the one-pass encode pair on one
schedule. Each option is lanes.cu edited in a copy under
``build/lanes_options/`` and built alone with ``nvcc``:

  package   K12 with the half in the grid (block = (lane tile, half)),
            each element stored as its half's u16 of the stored word;
            the two-exchange split from 2^12 on (K12) and from 2^11 on
            (K11) with TL = 4 lanes a block (1024 threads at 2^12 and
            2^13), but TL = 2 for K11 in GF32 at 2^13; the one-exchange
            form held to two blocks an SM;
  tl2       TL = 2 in every two-exchange form (512 threads, 8-byte row
            segments);
  split11   K12's two-exchange split from 2^11 on (16 * 16 * 8 there);
  split13   K12's two-exchange split at 2^13 only (the one-exchange
            form, 64 elements a thread, at 2^12);
  lb_none   no minimum of blocks an SM anywhere (the one-argument
            __launch_bounds__: ptxas' own register choice);
  k11_split12  K11's two-exchange split from 2^12 on (K12's);
  k11_tl4   K11 in GF32 at 2^13 with TL = 4 (1024 threads);
  k11_lb1   K11's two-exchange form held to one block an SM (K12's
            bound there) in place of ptxas' own register choice;
  seq16     both halves in one block, one after the other (the tile copied
            in again for hi, from L2), u16 stores;
  parked    both halves in one block, lo's result parked in registers while
            hi runs, then whole stored words and both halves' escape bits.

(split11, split13, seq16 and parked change K12 alone, k11_split12,
k11_tl4 and k11_lb1 K11 alone.) Each is held equal to the package's
K12 at every k = 4 .. 2^13 over Wu = 8, 40 and 1024 and on dense escapes
at k = 32 and 2^13, and to its K11 at every k in both fields over 13 and
1088 lanes, then timed in turns (CUDA events, chip_smoke.event_ms): K12
on 128 MiB of pairs at k = 2^10 .. 2^13 and at the GF16 wire encode's
[2^13, 16384]; K11 (the options that change it) at the GF32 batch
encode's [2^10, 65536] and on 128 MiB at k = 2^9 .. 2^13 in both fields.
Prints ptxas' registers and spills of every K11 and K12 instantiation.
With arguments, only the named kernel's checks and times run.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from fastecc_tpu_torch.fields import GF16, GF32
from fastecc_tpu_torch.kernels import _build
from fastecc_tpu_torch.kernels import ntt_mfa as m

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "lanes_options"
KERNEL_START = "// K12: block = (lane tile, half), the half the fastest index"
KERNEL_END = "// K11 (WIRE false, field F) or K12 (WIRE, GF16)"
GRID = "WIRE ? 2u * tiles : tiles"

ONE_BLOCK = r'''
// K12 with both halves in one block: lo, then hi after the tile is copied
// in again; the option gives each half's epilogue.
template <int LA>
__global__ void __launch_bounds__(LanesShape<fecc::kGF16, LA, true>::kThreads,
                                  LanesShape<fecc::kGF16, LA, true>::kMinBlocks)
    pair_lanes_wire16_kernel(LanesArgs p) {
  using W = LanesShape<fecc::kGF16, LA, true>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int l0 = blockIdx.x * W::TL;
  const int lane = l0 + threadIdx.x % W::TL;
  const bool live = lane < p.L;
  uint32_t* bm = p.bitmap + (lane >> 3);
  const int sh = 2 * (lane & 7);
  const int words = p.L >> 3;
  uint32_t park[W::Inner::A1];
  (void)park;
  load_block<W>(smem, p, l0);
  pair_columns<fecc::kGF16, LA, true>(
      p, smem, [](uint32_t v) { return v & 0xFFFFu; }, live,
      [&](auto i, uint32_t v, int row) {
    STORE_LO
  });
  __syncthreads();
  load_block<W>(smem, p, l0);
  pair_columns<fecc::kGF16, LA, true>(
      p, smem, [](uint32_t v) { return v >> 16; }, live,
      [&](auto i, uint32_t v, int row) {
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


def edit(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, old
    return src.replace(old, new)


BOUNDS = re.compile(r"__launch_bounds__\((LanesShape<[^>]*>::kThreads),"
                    r"\s*(LanesShape<[^>]*>::kMinBlocks|2)\)")


def both_bounds(src: str) -> str:
    """K11 and K12 with the one-argument __launch_bounds__."""
    src, n = BOUNDS.subn(r"__launch_bounds__(\1)", src)
    assert n == 2
    return src


def one_block(lo: str, hi: str):
    def f(src: str) -> str:
        a, b = src.index(KERNEL_START), src.index(KERNEL_END)
        body = ONE_BLOCK.replace("STORE_LO", lo).replace("STORE_HI", hi)
        return edit(src[:a] + body + src[b:], GRID,
                    GRID.replace("2u *", "1u *"))
    return f


VARIANTS = {
    "package": lambda s: s,
    "tl2": lambda s: edit(s, "constexpr int kTwoExchangeTL = 4;",
                          "constexpr int kTwoExchangeTL = 2;"),
    "split11": lambda s: edit(s, "constexpr int kTwoExchangeLog = 12;",
                              "constexpr int kTwoExchangeLog = 11;"),
    "split13": lambda s: edit(s, "constexpr int kTwoExchangeLog = 12;",
                              "constexpr int kTwoExchangeLog = 13;"),
    "lb_none": lambda s: both_bounds(s),
    "seq16": one_block(SEQ16_LO, SEQ16_HI),
    "parked": one_block(PARKED_LO, PARKED_HI),
    "k11_split12": lambda s: edit(s, "constexpr int kTwoExchangeLogK11 = 11;",
                                  "constexpr int kTwoExchangeLogK11 = 12;"),
    "k11_tl4": lambda s: edit(s, "constexpr int kNarrowTL = 2;",
                              "constexpr int kNarrowTL = 4;"),
    "k11_lb1": lambda s: edit(
        s, "__launch_bounds__(LanesShape<F, LA, false>::kThreads)\n",
        "__launch_bounds__(LanesShape<F, LA, false>::kThreads, 1)\n"),
}
# where each option's split takes two exchanges, per kernel
TWO_EXCHANGE_LOG = {"K12": {"split11": 11, "split13": 13},
                    "K11": {"k11_split12": 12}}
# the options that change K11 (the others change K12 alone)
K11_OPTIONS = ("package", "tl2", "lb_none", "k11_split12", "k11_tl4",
               "k11_lb1")


def ptxas(log: str, tag: str) -> None:
    name = None
    for line in log.splitlines():
        mm = re.search(r"Compiling entry function '(\S+)'", line)
        if mm:
            name = mm.group(1)
            continue
        k12 = name and re.search(r"pair_lanes_wire16_kernelILi(\d+)E", name)
        k11 = name and re.search(
            r"pair_lanes_kernel(?:_lb2)?ILi(\d)ELi(\d+)E", name)
        if (k11 or k12) and ("Used" in line or "spill" in line):
            what = (f"K11 F{k11.group(1)} LA{k11.group(2)}" if k11 else
                    f"K12 LA{k12.group(1)}")
            cs.say(f"[{tag}] {what}: {line.split(':', 1)[-1].strip()}")


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
        for entry in ("fecc_pair_lanes", "fecc_pair_lanes_wire16"):
            fn = getattr(lib, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def tables(kernel: str, name: str, field, k: int, g: int, dev: str):
    """The option's tables: the package's for the split that option
    takes (kernels/ntt_mfa.py _lanes_tables_on)."""
    package = {"K11": m.K11_TWO_EXCHANGE_K, "K12": m.K12_TWO_EXCHANGE_K}
    two_k = 1 << TWO_EXCHANGE_LOG[kernel].get(name, m._log2(package[kernel]))
    return m._lanes_tables_on(field.name, k, g % field.p, two_k, dev)


def launcher(name: str, lib, x: torch.Tensor, g: int):
    """The option library's K12 on [k, Wu] pairs."""
    k, wu = x.shape
    tabs = tables("K12", name, GF16, k, g, str(x.device))
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


def launcher11(name: str, lib, field, x: torch.Tensor, g: int):
    """The option library's K11 on [k, L] field values."""
    k, lanes = x.shape
    tabs = tables("K11", name, field, k, g, str(x.device))
    out = torch.empty_like(x)

    def call():
        code = lib.fecc_pair_lanes(
            m._field_code(field), x.data_ptr(), out.data_ptr(), k, lanes,
            *(None if t is None else t.data_ptr() for t in tabs),
            torch.cuda.current_stream().cuda_stream)
        cs.check(code == 0, f"{name}: fecc_pair_lanes returned {code}")
        return out
    return call


def pairs(k: int, wu: int, gen) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, (k, wu), dtype=torch.int32,
                         device="cuda", generator=gen).view(torch.uint32)


def in_turns(fns: dict) -> str:
    """Each of ``fns`` timed there and back (CUDA events)."""
    order = list(fns)
    ms = {}
    for name in order + order[::-1]:
        ms.setdefault(name, []).append(cs.event_ms(fns[name]))
    return (f"ms in turns {order} then back: " +
            "; ".join(f"{n} {t[0]:.4f} / {t[1]:.4f}" for n, t in ms.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("lanes_options: no CUDA device", file=sys.stderr)
        return 2
    parts = set(sys.argv[1:]) or {"k11", "k12"}
    cs.say(cs.card_line())
    b = _build.build()
    ptxas(b.log, "package (the package's build)")
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(11)
    if "k12" in parts:
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
        for k, wu in ((1 << 10, 1 << 15), (1 << 11, 1 << 14),
                      (1 << 12, 1 << 13), (1 << 13, 1 << 12),
                      (1 << 13, 1 << 14)):
            g = GF16.root_of_order(2 * k)
            x = pairs(k, wu, gen)
            fns = {name: launcher(name, lib, x, g)
                   for name, lib in libs.items()}
            cs.say(f"[lanes_options] K12 [{k}, {wu}] pairs, {in_turns(fns)}")
            del x, fns
    if "k11" not in parts:
        return 0
    k11 = {name: libs[name] for name in K11_OPTIONS}
    for field in (GF32, GF16):
        for la in range(2, 14):
            k = 1 << la
            g = field.root_of_order(2 * k)
            for lanes in (13, 1088):
                x = cs.rand_field(field.p, (k, lanes), gen)
                want = m.ntt_pair_lanes(x, field, g)
                for name, lib in k11.items():
                    cs.check(torch.equal(
                        launcher11(name, lib, field, x, g)(), want),
                        f"{name} != the package's K11 at {field.name} "
                        f"k = {k}, L = {lanes}")
    cs.say(f"[lanes_options] {sorted(k11)} == the package's K11 at every k = "
           f"4 .. 2^13 in both fields over 13 and 1088 lanes")
    shapes = [(GF32, 1 << 10, 1 << 16)] + [
        (field, 1 << la, 1 << (25 - la)) for field in (GF32, GF16)
        for la in range(9, 14)]
    for field, k, lanes in shapes:
        g = field.root_of_order(2 * k)
        x = cs.rand_field(field.p, (k, lanes), gen)
        fns = {name: launcher11(name, lib, field, x, g)
               for name, lib in k11.items()}
        cs.say(f"[lanes_options] K11 {field.name} [{k}, {lanes}], "
               f"{in_turns(fns)}")
        del x, fns
    return 0


if __name__ == "__main__":
    sys.exit(main())
