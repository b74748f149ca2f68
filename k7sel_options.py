"""K7-sel's reads of the kept rows and its register bound, measured on
the card.

    python3 k7sel_options.py

A developer's measurement, run from the repo's root on one NVIDIA GPU; no
entry point of the package uses it. K7-sel (``fastecc_tpu_torch/csrc/
row.cu``: the body ``row_post`` with the merge under ``row_sel_kernel``
below A = 512 and ``row_sel_kernel_lb2`` from 512 on) keeps the rows whose
mask is 0 from ``orig``.
Each option is row.cu edited in a copy under ``build/k7sel_options/``
and built alone with ``nvcc``:

  a_lb2     the package: the loads in the store loop (read-only,
            predicated by the row's mask, every load of a group before
            its first store), held to two blocks an SM at A >= 512,
            ptxas' own choice below;
  a         the same without the bound at A >= 512;
  a_tied    a with the load tied to its register by inline PTX;
  a_tied_lb2  the same with the package's bounds;
  b         cp.async copies of the kept rows into the exchange freed after
            step 2's reads, overlapped with the A2-point DIFs, read from
            shared memory at the store; no bound;
  b_lb2     b with the package's bounds;
  a_lb1     the package with a bound of one block an SM below 512;
  a_lb2_all the package with a bound of two blocks an SM below 512.

Each is held equal to the package's K7-sel at every A = 2 .. 1024 in both
fields and directions (the original apart and the pass's input), then
timed in turns (CUDA events, chip_smoke.event_ms) with a mask about half
set and K3 on the same tensor beside them: the first six at the decode's
[1024, 1024, 512], the package and the other bounds at [512, 2048, 512]
and [256, 4096, 512] (the same 2^29 elements). Prints ptxas' registers
and spills at A >= 256.
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
OUT = ROOT / "build" / "k7sel_options"

OPT_B = r'''
template <class S>
__device__ __forceinline__ void load_kept_async(uint32_t* tile,
                                                const uint32_t* x, int B,
                                                int L, int b, int l0,
                                                bool vec,
                                                const uint32_t* mask) {
  const size_t row = (size_t)B * L;
  const uint32_t* base = x + (size_t)b * L + l0;
  if (vec) {
    constexpr int kChunks = S::A * S::TL / 4, kPerRow = S::TL / 4;
    fecc::static_for<(kChunks + S::kThreads - 1) / S::kThreads>([&](auto i) {
      const int c = threadIdx.x + decltype(i)::value * S::kThreads;
      if (kChunks % S::kThreads == 0 || c < kChunks) {
        const int a = c / kPerRow, l = (c % kPerRow) * 4;
        const bool in = l0 + l < L && mask[a] == 0u;
        fecc::cp_async16(tile + a * S::TL + l, in ? base + a * row + l : x,
                         in ? 16 : 0);
      }
    });
  } else {
    constexpr int kWords = S::A * S::TL;
    fecc::static_for<kWords / S::kThreads>([&](auto i) {
      const int e = threadIdx.x + decltype(i)::value * S::kThreads;
      const int a = e / S::TL, l = e % S::TL;
      const bool in = l0 + l < L && mask[a] == 0u;
      fecc::cp_async4(tile + e, in ? base + a * row + l : x, in ? 4 : 0);
    });
  }
}

template <int F, int LA, int INV>
__device__ __forceinline__ void row_sel(const RowArgs& p) {
  using S = RegSplit<LA>;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tile = smem;
  uint32_t* tw = smem + S::kExchWords;
  uint32_t* post = smem + S::kSmemWords;
  uint32_t* mask = post + S::A;
  const int lt = blockIdx.x % p.lane_tiles;
  const int b = blockIdx.x / p.lane_tiles;
  const int l0 = lt * S::TL;
  fecc::load_tile_async<S>(tile, p.x, p.B, p.L, b, l0, p.vec != 0);
  fecc::load_twiddles_async<S>(tw, p.tw);
  fecc::load_row_async<S>(post, p.post + b, p.B);
  fecc::load_row_async<S>(mask, p.mask + b, p.B);
  fecc::cp_async_wait_all();
  __syncthreads();
  const int l = threadIdx.x % S::TL, t = threadIdx.x / S::TL;
  uint32_t r[S::A1];
  fecc::static_for<S::A1>([&](auto n1) {
    r[decltype(n1)::value] =
        tile[(decltype(n1)::value * S::A2 + t) * S::TL + l];
  });
  fecc::dif_regs<F, INV != 0, S::A1, 0>(r);
  __syncthreads();
  uint32_t* rowp = tile + t * S::kRowWords + l;
  const uint32_t* twr = tw + t * S::kTwStride;
  fecc::static_for<S::A1>([&](auto k1c) {
    constexpr int k1 = decltype(k1c)::value;
    uint32_t v = r[fecc::bitrev(k1, S::LA1)];
    if constexpr (k1 != 0) v = mul_full<F>(v, twr[k1]);
    rowp[k1 * S::TL] = v;
  });
  __syncthreads();
  fecc::static_for<S::A1 / S::A2>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    const uint32_t* col = tile + (t + S::A2 * j) * S::TL + l;
    fecc::static_for<S::A2>([&](auto n2) {
      r[j * S::A2 + decltype(n2)::value] =
          col[decltype(n2)::value * S::kRowWords];
    });
  });
  __syncthreads();
  const bool vo = ((uintptr_t)p.orig % 16 == 0) && (p.L % 4 == 0);
  load_kept_async<S>(tile, p.orig, p.B, p.L, b, l0, vo, mask);
  fecc::static_for<S::A1 / S::A2>([&](auto jc) {
    fecc::dif_regs<F, INV != 0, S::A2, decltype(jc)::value * S::A2>(r);
  });
  fecc::cp_async_wait_all();
  __syncthreads();
  if (l0 + l >= p.L) return;
  const size_t row = (size_t)p.B * p.L;
  uint32_t* out = p.out + (size_t)b * p.L + l0 + l;
  fecc::static_for<S::A1 / S::A2>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    fecc::static_for<S::A2>([&](auto k2c) {
      constexpr int k2 = decltype(k2c)::value;
      constexpr int src = j * S::A2 + fecc::bitrev(k2, S::LA2);
      const int k = t + S::A2 * j + S::A1 * k2;
      out[(size_t)k * row] = mask[k] != 0u ? mul_full<F>(r[src], post[k])
                                           : tile[k * S::TL + l];
    });
  });
}
'''


TIED = r'''
__device__ __forceinline__ void ldg_if_zero(uint32_t& r, uint32_t m,
                                            const uint32_t* a) {
  asm volatile("{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n"
               " @p ld.global.nc.u32 %0, [%2];\n}\n"
               : "+r"(r) : "r"(m), "l"(a));
}

'''




LB_2 = ("__launch_bounds__(RegSplit<LA>::kThreads, 2)\n"
        "    row_sel_kernel_lb2(RowArgs p)")
LB_SEL = ("__launch_bounds__(RegSplit<LA>::kThreads)\n"
          "    row_sel_kernel(RowArgs p)")


def edit(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, old
    return src.replace(old, new)


def unbound(src: str) -> str:
    return edit(src, LB_2, LB_2.replace(", 2)", ")", 1))


def bound_below(blocks: int):
    return lambda src: edit(src, LB_SEL, LB_SEL.replace(
        "kThreads)", f"kThreads, {blocks})", 1))


def tie(src: str) -> str:
    src = edit(src, """      if constexpr (MERGE)
        r[src] = mask[k] != 0u ? mul_full<F>(r[src], post[k])
                               : __ldg(orig + (size_t)(k2 * S::A1) * row);""",
               """      if constexpr (MERGE) {
        const uint32_t mk = mask[k];
        if (mk != 0u) r[src] = mul_full<F>(r[src], post[k]);
        ldg_if_zero(r[src], mk, orig + (size_t)(k2 * S::A1) * row);
      }""")
    i = src.index("// K7 (MERGE false): K3, then out")
    return src[:i] + TIED + src[i:]


def exchange(src: str) -> str:
    """K7-sel's kernels on OPT_B's body instead of row_post's (K7 keeps
    row_post)."""
    at = src.index("template <int F, int LA, int INV>\n__global__ void "
                   "__launch_bounds__(RegSplit<LA>::kThreads)\n"
                   "    row_sel_kernel(")
    src = src[:at] + OPT_B + "\n" + src[at:]
    assert src.count("row_post<F, LA, INV, true>(p);") == 2
    return src.replace("row_post<F, LA, INV, true>(p);",
                       "row_sel<F, LA, INV>(p);")


VARIANTS = {
    "a": unbound,
    "a_tied": lambda s: tie(unbound(s)),
    "a_tied_lb2": tie,
    "b": lambda s: exchange(unbound(s)),
    "b_lb2": exchange,
    "a_lb1": bound_below(1),
    "a_lb2_all": bound_below(2),
}
TIMED = {1024: ("K3", "a_lb2", "a", "a_tied", "a_tied_lb2", "b", "b_lb2"),
         512: ("K3", "a_lb2", "a"),
         256: ("K3", "a_lb2", "a_lb1", "a_lb2_all")}


def ptxas(log: str, tag: str) -> None:
    name = None
    for line in log.splitlines():
        mm = re.search(r"Compiling entry function '(\S+)'", line)
        if mm:
            name = mm.group(1)
            continue
        km = name and re.search(
            r"row_sel_kernel(?:_lb2)?ILi(\d)ELi(\d+)ELi(\d)E", name)
        if not km:
            continue
        f, la, inv = km.groups()
        if int(la) >= 8 and ("Used" in line or "spill" in line):
            cs.say(f"[{tag}] F{f} LA{la} INV{inv}: "
                   f"{line.split(':', 1)[-1].strip()}")


def build_variants() -> dict:
    """{name: library}; the package's own kernel is a_lb2."""
    src = (ROOT / "fastecc_tpu_torch" / "csrc" / "row.cu").read_text()
    procs = {}
    for name, edit in VARIANTS.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "fastecc_tpu_torch" / "csrc", d)
        (d / "row.cu").write_text(edit(src))
        procs[name] = (d, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "row.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"{name} build:\n{log[-4000:]}")
        ptxas(log, name)
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.fecc_row_post_sel.argtypes = _build.SIGNATURES["fecc_row_post_sel"]
        lib.fecc_row_post_sel.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, field, y, v, mask, orig, inverse=False):
    out = torch.empty_like(y)
    tw = m._row_tw_on(field.name, y.shape[0], inverse, str(y.device))

    def call():
        code = lib.fecc_row_post_sel(
            m._field_code(field), y.data_ptr(), out.data_ptr(), *y.shape,
            int(inverse), tw.data_ptr(), v.data_ptr(), mask.data_ptr(),
            orig.data_ptr(), torch.cuda.current_stream().cuda_stream)
        cs.check(code == 0, f"fecc_row_post_sel returned {code}")
        return out
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("k7sel_options: no CUDA device", file=sys.stderr)
        return 2
    cs.say(cs.card_line())
    b = _build.build()
    ptxas(b.log, "a_lb2")
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for field in (GF32, GF16):
        for la in range(1, 11):
            a = 1 << la
            for lanes in (13, 40):
                y = cs.rand_field(field.p, (a, 3, lanes), gen)
                v = cs.rand_field(field.p, (a * 3,), gen)
                mk = torch.randint(0, 2, (a * 3,), dtype=torch.int32,
                                   device="cuda",
                                   generator=gen).view(torch.uint32)
                o = cs.rand_field(field.p, (a, 3, lanes), gen)
                for inv in (False, True):
                    for orig in (o, y):
                        want = m.row_pass_post(y, field, v, mk, orig, inv)
                        for name, lib in libs.items():
                            got = launcher(lib, field, y, v, mk, orig, inv)()
                            cs.check(torch.equal(got, want),
                                     f"{name} at {field.name} A = {a}")
    cs.say(f"[k7sel] {sorted(libs)} == the package's K7-sel at every A, "
           f"both fields and directions")
    for a in (1024, 512, 256):
        shape = (a, (1 << 20) // a, 512)
        y = cs.rand_field(GF32.p, shape, gen)
        orig = cs.rand_field(GF32.p, shape, gen)
        v = cs.rand_field(GF32.p, (1 << 20,), gen)
        mask = torch.randint(0, 2, (1 << 20,), dtype=torch.int32,
                             device="cuda", generator=gen).view(torch.uint32)
        fns = {"K3": lambda: m.row_pass(y, GF32),
               "a_lb2": lambda: m.row_pass_post(y, GF32, v, mask, orig),
               **{k: launcher(lib, GF32, y, v, mask, orig)
                  for k, lib in libs.items()}}
        fns = {k: fns[k] for k in TIMED[a]}
        for k in fns:
            if k != "K3":
                cs.check(torch.equal(fns[k](), fns["a_lb2"]()), k)
        order = list(fns)
        ms = {}
        for k in order + order[::-1]:
            ms.setdefault(k, []).append(cs.event_ms(fns[k]))
        cs.say(f"[k7sel] {shape}, mask about half set, ms in turns "
               f"{order} then back: " + "; ".join(
                   f"{k} {t[0]:.4f} / {t[1]:.4f}" for k, t in ms.items()))
        del y, orig, fns
    return 0


if __name__ == "__main__":
    sys.exit(main())
