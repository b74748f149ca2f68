"""K7's register bound, K8's layout and K10's layout, measured on the
card.

    python3 pass_options.py [k7] [k8] [k10]

A developer's measurement, run from the repo's root on one NVIDIA GPU; no
entry point of the package uses it. K7 (``fastecc_tpu_torch/csrc/row.cu``:
the body ``row_post`` under ``row_post_kernel`` below A = 2^kBoundLog and
``row_post_kernel_lb2``, held to two blocks an SM, from there on) is pass
B with the decode's table multiply in its store. Each option is row.cu
with ``kBoundLog`` edited, in a copy under ``build/pass_options/``, built
alone with ``nvcc``:

  unbounded  ptxas' own register choice at every A (kBoundLog past the
             longest pass);
  bounded    two blocks an SM at every A (kBoundLog = 1).

At each A one of them is the package's kernel. Each is held equal to the
package's K7 at every A = 2 .. 1024 in both fields and directions, then
timed in turns (CUDA events, chip_smoke.event_ms) at [A, 2^20 / A, 512]
GF32 (the decode's 2^29 elements) for A = 256, 512 and 1024, with K3 on
the same tensor beside them. Prints ptxas' registers and spills of K7 at
A >= 256.

K8 (``csrc/col.cu``, ``col_kernel`` mode kColWire16) runs both halves of
the pairs in one block: one tile read, step 1 splitting each word into two
register arrays, two transforms, both halves stored. The option
``k8_halves`` is col.cu with a kernel of one half a block added and
launched for K8 (the half the fastest block index, so that a column's
two blocks run side by side and the second read of its tile comes from
L2). It is held equal to the package's K8 at every C1 = 2 .. 1024 over
Wu = 8 and 40, then timed in turns at the GF16 wire encode's
[64, 128, 16384] pairs and at [128, 256, 4096] (k = 2^15, the wire
gate's largest C1), with its ptxas lines.

K10 (``csrc/row.cu`` ``row_wire16_kernel``) runs K3's GF16 schedule on
both halves in one block, each half's exchange through a region of its
own (lo's result in registers while hi's transform runs), and ORs the
escape bits into the bitmap its entry zeroes (K12's form). Options,
row.cu edited:

  k10_one_region  one exchange region: hi's tile in a plain [A, TL] area,
                  read into registers before lo's exchange overwrites
                  the region, then hi's exchange through it (K8's form;
                  A2 * TL words less shared memory);
  k10_ballots     each escape word built from two warp ballots a row and
                  written once by the first lanes of its row segment (at
                  TL = 16 each half-warp reads its own 16 bits): no
                  zeroing, no atomics.

Each is held equal to the package's K10 at every A = 2 .. 1024 over Wu =
8 and 40, then timed in turns at the wire encode's [2, 64, 128, 16384]
halves and at [2, 512, 64, 4096], there and back three times, with its
ptxas lines.

With arguments, only the named kernels' options run.
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
OUT = ROOT / "build" / "pass_options"
BOUND = "constexpr int kBoundLog = "
VARIANTS = {"unbounded": 11, "bounded": 1}

# K8 with one half a block (inserted into col.cu, launched for kColWire16
# in place of col_kernel's mode): block 2 i + h runs half h of block i
HALVES = r"""
template <int LA>
__global__ void __launch_bounds__(RegSplit<LA>::kThreads)
    col_wire16_half_kernel(ColArgs p) {
  using S = RegSplit<LA>;
  constexpr int F = fecc::kGF16;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tile = smem;
  uint32_t* tw1 = smem + S::kExchWords;
  uint32_t* fac = tw1 + S::A2 * S::kTwStride;
  const int half = blockIdx.x & 1;
  const int lt = (blockIdx.x >> 1) % p.lane_tiles;
  const int b = (blockIdx.x >> 1) / p.lane_tiles;
  const int l0 = lt * S::TL;
  fecc::load_tile_async<S>(tile, p.x, p.B, p.L, b, l0, p.vec != 0);
  fecc::load_twiddles_async<S>(tw1, p.tw1);
  const int j = b & ((1 << p.log_tr) - 1);
  const uint32_t* t0 = p.t0 + (size_t)(b >> p.log_tr) * S::A;
  for (int k = threadIdx.x; k < S::A; k += S::kThreads)
    fac[k] = mul_full<F>(p.seed[(k << p.log_tr) + j], t0[k]);
  fecc::cp_async_wait_all();
  __syncthreads();
  const int l = threadIdx.x % S::TL, t = threadIdx.x / S::TL;
  uint32_t r[S::A1];
  fecc::static_for<S::A1>([&](auto n1) {
    r[decltype(n1)::value] =
        (tile[(decltype(n1)::value * S::A2 + t) * S::TL + l] >> (16 * half)) &
        0xFFFFu;
  });
  fecc::reg_transform_regs<F, true, S>(r, tile, tw1, t, l);
  if (l0 + l >= p.L) return;
  uint32_t* out = p.out + (size_t)half * S::A * p.B * p.L +
                  (size_t)b * S::A * p.L + l0 + l;
  fecc::static_for<S::A1 / S::A2>([&](auto jc) {
    constexpr int jj = decltype(jc)::value;
    const int k1 = t + S::A2 * jj;
    uint32_t* o = out + (size_t)k1 * p.L;
    fecc::static_for<S::A2>([&](auto k2c) {
      constexpr int k2 = decltype(k2c)::value;
      constexpr int src = jj * S::A2 + fecc::bitrev(k2, S::LA2);
      o[(size_t)(k2 * S::A1) * p.L] =
          mul_full<F>(r[src], fac[k1 + k2 * S::A1]);
    });
  });
}

template <int LA>
cudaError_t launch_halves(ColArgs p, cudaStream_t stream) {
  using S = RegSplit<LA>;
  const size_t smem = (size_t)smem_words<LA, kColWire16>() * sizeof(uint32_t);
  auto kernel = col_wire16_half_kernel<LA>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  p.lane_tiles = (p.L + S::TL - 1) / S::TL;
  kernel<<<2u * (unsigned)p.B * (unsigned)p.lane_tiles, S::kThreads, smem,
           stream>>>(p);
  return cudaGetLastError();
}

"""
LAUNCH_K8 = "fecc::kGF16 ? launch<fecc::kGF16, LA, 1, MODE>(p, s)"


def halves(src: str) -> str:
    assert src.count(LAUNCH_K8) == 1
    src = src.replace(LAUNCH_K8, "fecc::kGF16 ? launch_halves<LA>(p, s)")
    at = src.index("// The seams run their first transform inverse")
    return src[:at] + HALVES + src[at:]


# K10 with one exchange region (row.cu text edits)
K10_TRANSFORMS = """  fecc::reg_transform<F, false, S>(lo, tlo, tw, t, l);
  fecc::reg_transform<F, false, S>(hi, thi, tw, t, l);"""
K10_ONE_REGION = """  fecc::static_for<S::A1>([&](auto n1) {
    hi[decltype(n1)::value] =
        thi[(decltype(n1)::value * S::A2 + t) * S::TL + l];
  });
  fecc::reg_transform<F, false, S>(lo, tlo, tw, t, l);
  fecc::reg_transform_regs<F, false, S>(hi, tlo, tw, t, l);"""
K10_TW = "  uint32_t* tw = thi + S::kExchWords;"
K10_SMEM = "SEL == kWire16 ? S::kExchWords : 0;"

# K10 with the escape words from warp ballots, no zeroing, no atomics
K10_EPILOGUE_START = ("  if (l0 + l >= p.L) return;\n"
                      "  // natural order, as K3: row k1 + A1 k2")
K10_EPILOGUE_END = "      if (bits) atomicOr(bm + k * p.B * words, bits);\n"
K10_BALLOTS = """  // natural order, as K3; the ballots take every thread of the warp,
  // so no lane returns before them
  const bool live = l0 + l < p.L;
  const int words = p.L >> 3;
  // this thread's row segment starts at bit `seg` of a ballot; the
  // segment's first TL / 8 lanes write its groups, group l
  const int seg = threadIdx.x & 31 & ~(S::TL - 1);
  const bool writer = l < S::TL / 8 && l0 + 8 * l < p.L;
  const size_t row = (size_t)p.B * p.L;
  uint32_t* out = p.out + (size_t)b * p.L + l0 + l;
  uint32_t* bm = p.bitmap + (size_t)b * words + (l0 >> 3) + l;
  fecc::static_for<S::A1 / S::A2>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    const int k1 = t + S::A2 * j;
    fecc::static_for<S::A2>([&](auto k2c) {
      constexpr int k2 = decltype(k2c)::value;
      constexpr int src = j * S::A2 + fecc::bitrev(k2, S::LA2);
      const size_t k = (size_t)k1 + k2 * S::A1;
      const uint32_t vl = lo[src], vh = hi[src];
      if (live) out[k * row] = (vl & 0xFFFFu) | (vh << 16);
      const uint32_t bl = __ballot_sync(0xFFFFFFFFu, live && (vl >> 16));
      const uint32_t bh = __ballot_sync(0xFFFFFFFFu, live && (vh >> 16));
      // lanes 8g .. 8g + 7 of the segment, g = l mod TL / 8: lo's 8 bits
      // at even places, hi's at odd ones
      const int sh = seg + 8 * (l & (S::TL / 8 - 1));
      uint32_t x = ((bl >> sh) & 0xFFu) | ((bh >> sh) & 0xFFu) << 16;
      x = (x | x << 4) & 0x0F0F0F0Fu;
      x = (x | x << 2) & 0x33333333u;
      x = (x | x << 1) & 0x55555555u;
      if (writer) bm[k * p.B * words] = (x & 0xFFFFu) | (x >> 15);
"""
K10_MEMSET_START = "  const cudaError_t e = cudaMemsetAsync(\n      bitmap, 0,"
K10_MEMSET_END = "  if (e != cudaSuccess) return (int)e;\n"


def edit(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, old
    return src.replace(old, new)


def one_region(src: str) -> str:
    src = edit(src, K10_TRANSFORMS, K10_ONE_REGION)
    src = edit(src, K10_TW, "  uint32_t* tw = thi + S::A * S::TL;")
    return edit(src, K10_SMEM, "SEL == kWire16 ? S::A * S::TL : 0;")


def ballots(src: str) -> str:
    assert src.count(K10_EPILOGUE_START) == 1
    a = src.index(K10_EPILOGUE_START)
    b = src.index(K10_EPILOGUE_END) + len(K10_EPILOGUE_END)
    src = src[:a] + K10_BALLOTS + src[b:]
    a = src.index(K10_MEMSET_START)
    b = src.index(K10_MEMSET_END, a) + len(K10_MEMSET_END)
    return src[:a] + src[b:]


def bound_from(log: int):
    def edit(src: str) -> str:
        assert src.count(BOUND) == 1
        i = src.index(BOUND) + len(BOUND)
        return src[:i] + str(log) + src[src.index(";", i):]
    return edit


def ptxas(log: str, tag: str) -> None:
    name = None
    for line in log.splitlines():
        mm = re.search(r"Compiling entry function '(\S+)'", line)
        if mm:
            name = mm.group(1)
            continue
        k8 = name and re.search(
            r"col_wire16_half_kernelILi(\d+)E|col_kernelILi1ELi(\d+)ELi1ELi5E",
            name)
        if k8 and ("Used" in line or "spill" in line):
            la = k8.group(1) or k8.group(2)
            kind = "halves" if k8.group(1) else "one block"
            cs.say(f"[{tag}] K8 ({kind}) LA{la}: "
                   f"{line.split(':', 1)[-1].strip()}")
            continue
        k10 = name and re.search(r"row_wire16_kernelILi(\d+)E", name)
        if k10 and ("Used" in line or "spill" in line):
            cs.say(f"[{tag}] K10 LA{k10.group(1)}: "
                   f"{line.split(':', 1)[-1].strip()}")
            continue
        km = name and re.search(
            r"row_post_kernel(_lb2)?ILi(\d)ELi(\d+)ELi(\d)E", name)
        if not km:
            continue
        lb2, f, la, inv = km.groups()
        if int(la) >= 8 and ("Used" in line or "spill" in line):
            cs.say(f"[{tag}] {'lb2 ' if lb2 else ''}F{f} LA{la} INV{inv}: "
                   f"{line.split(':', 1)[-1].strip()}")


def build_variants(parts) -> dict:
    """{name: library}: for ``k7`` row.cu alone for each bound, for ``k8``
    col.cu alone with K8 one half a block (``k8_halves``), for ``k10``
    row.cu alone with each K10 option."""
    csrc = ROOT / "fastecc_tpu_torch" / "csrc"
    jobs = {}
    if "k7" in parts:
        jobs.update({name: ("row.cu", bound_from(log), "fecc_row_post")
                     for name, log in VARIANTS.items()})
    if "k8" in parts:
        jobs["k8_halves"] = ("col.cu", halves, "fecc_col_wire16")
    if "k10" in parts:
        jobs["k10_one_region"] = ("row.cu", one_region, "fecc_row_wire16")
        jobs["k10_ballots"] = ("row.cu", ballots, "fecc_row_wire16")
    procs = {}
    for name, (source, edit_src, _) in jobs.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        (d / source).write_text(edit_src((csrc / source).read_text()))
        procs[name] = (d, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"{name} build:\n{log[-4000:]}")
        ptxas(log, name)
        lib = ctypes.CDLL(str(d / "lib.so"))
        entry = getattr(lib, jobs[name][2])
        entry.argtypes = _build.SIGNATURES[jobs[name][2]]
        entry.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher8(lib, x):
    """The option library's K8 on [C1, R1, Wu] pairs, as col_pass_wire16
    calls it."""
    c, r, lanes = x.shape
    dev = str(x.device)
    tr = m._seed_tr(r)
    tw = m._row_tw_on(GF16.name, c, True, dev)
    seed, t0 = m._seeds_on(GF16.name, c * r, c, True, True, tr, dev)
    out = torch.empty((2, r, c, lanes), dtype=torch.uint32, device=dev)

    def call():
        code = lib.fecc_col_wire16(
            1, x.data_ptr(), out.data_ptr(), c, r, lanes, tw.data_ptr(),
            seed.data_ptr(), t0.data_ptr(), tr,
            torch.cuda.current_stream().cuda_stream)
        cs.check(code == 0, f"fecc_col_wire16 returned {code}")
        return out
    return call


def launcher10(lib, h):
    """The option library's K10 on [2, R2, C2, Wu] halves, as
    wire16_pass_b2 calls it."""
    _, r, c, lanes = h.shape
    tw = m._row_tw_on(GF16.name, r, False, str(h.device))
    stored = torch.empty((r * c, lanes), dtype=torch.uint32, device=h.device)
    bitmap = torch.empty((r * c, lanes // 8), dtype=torch.uint32,
                         device=h.device)

    def call():
        code = lib.fecc_row_wire16(
            1, h[0].data_ptr(), h[1].data_ptr(), stored.data_ptr(),
            bitmap.data_ptr(), r, c, lanes, tw.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        cs.check(code == 0, f"fecc_row_wire16 returned {code}")
        return stored, bitmap
    return call


def in_turns(fns: dict, rounds: int = 1) -> dict:
    """{name: [ms, ...]}: each of ``fns`` timed there and back, ``rounds``
    times."""
    ms = {}
    for _ in range(rounds):
        for k in list(fns) + list(fns)[::-1]:
            ms.setdefault(k, []).append(cs.event_ms(fns[k]))
    return ms


def pairs(gen, *shape):
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                         device="cuda", generator=gen).view(torch.uint32)


def launcher(lib, field, y, v, inverse=False):
    out = torch.empty_like(y)
    tw = m._row_tw_on(field.name, y.shape[0], inverse, str(y.device))

    def call():
        code = lib.fecc_row_post(
            m._field_code(field), y.data_ptr(), out.data_ptr(), *y.shape,
            int(inverse), tw.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        cs.check(code == 0, f"fecc_row_post returned {code}")
        return out
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("pass_options: no CUDA device", file=sys.stderr)
        return 2
    parts = set(sys.argv[1:]) or {"k7", "k8", "k10"}
    cs.say(cs.card_line())
    b = _build.build()
    ptxas(b.log, "package")
    libs = build_variants(parts)
    gen = torch.Generator(device="cuda").manual_seed(12)
    if "k8" in parts:
        k8_halves = libs.pop("k8_halves")
        for la in range(1, 11):
            for wu in (8, 40):
                x = pairs(gen, 1 << la, 4, wu)
                cs.check(torch.equal(launcher8(k8_halves, x)(),
                                     m.col_pass_wire16(x, GF16)),
                         f"k8_halves at C1 = {1 << la}, Wu = {wu}")
        cs.say("[pass_options] k8_halves == the package's K8 at every C1, "
               "Wu = 8 and 40")
        for shape in ((64, 128, 16384), (128, 256, 4096)):
            x = pairs(gen, *shape)
            fns = {"package": lambda: m.col_pass_wire16(x, GF16),
                   "k8_halves": launcher8(k8_halves, x)}
            cs.check(torch.equal(fns["k8_halves"](), fns["package"]()),
                     "k8_halves")
            cs.say(f"[pass_options] K8 {shape} pairs, ms in turns there and "
                   f"back: " + "; ".join(f"{k} {t[0]:.4f} / {t[1]:.4f}"
                                         for k, t in in_turns(fns).items()))
            del x, fns
    if "k10" in parts:
        k10 = {k: libs.pop(k) for k in ("k10_one_region", "k10_ballots")}
        for la in range(1, 11):
            for wu in (8, 40):
                h = cs.rand_field(GF16.p, (2, 1 << la, 3, wu), gen)
                want = m.wire16_pass_b2(h[0], h[1], GF16)
                for name, lib in k10.items():
                    cs.check(cs.same(launcher10(lib, h)(), want),
                             f"{name} at A = {1 << la}, Wu = {wu}")
        cs.say(f"[pass_options] {sorted(k10)} == the package's K10 at every "
               f"A, Wu = 8 and 40")
        for shape in ((2, 64, 128, 16384), (2, 512, 64, 4096)):
            h = cs.rand_field(GF16.p, shape, gen)
            fns = {"package": launcher10(_build.library(), h),
                   **{k: launcher10(lib, h) for k, lib in k10.items()}}
            for k in k10:
                cs.check(cs.same(fns[k](), fns["package"]()), k)
            cs.say(f"[pass_options] K10 {shape}, ms in turns there and back, "
                   f"three times: " + "; ".join(
                       f"{k} " + " / ".join(f"{v:.4f}" for v in t)
                       for k, t in in_turns(fns, rounds=3).items()))
            del h, fns
    if "k7" not in parts:
        return 0
    for field in (GF32, GF16):
        for la in range(1, 11):
            a = 1 << la
            for lanes in (13, 40):
                y = cs.rand_field(field.p, (a, 3, lanes), gen)
                v = cs.rand_field(field.p, (a * 3,), gen)
                for inv in (False, True):
                    want = m.row_pass_post(y, field, v, inverse=inv)
                    for name, lib in libs.items():
                        got = launcher(lib, field, y, v, inv)()
                        cs.check(torch.equal(got, want),
                                 f"{name} at {field.name} A = {a}")
    cs.say(f"[pass_options] {sorted(libs)} == the package's K7 at every A, "
           f"both fields and directions")
    for a in (1024, 512, 256):
        shape = (a, (1 << 20) // a, 512)
        y = cs.rand_field(GF32.p, shape, gen)
        v = cs.rand_field(GF32.p, (1 << 20,), gen)
        fns = {"K3": lambda: m.row_pass(y, GF32),
               "package": lambda: m.row_pass_post(y, GF32, v),
               **{k: launcher(lib, GF32, y, v) for k, lib in libs.items()}}
        for k in libs:
            cs.check(torch.equal(fns[k](), fns["package"]()), k)
        cs.say(f"[pass_options] K7 {shape} GF32, ms in turns {list(fns)} "
               f"then back: " + "; ".join(f"{k} {t[0]:.4f} / {t[1]:.4f}"
                                          for k, t in in_turns(fns).items()))
        del y, v, fns
    return 0


if __name__ == "__main__":
    sys.exit(main())
