"""K14's Solinas step and K15's hand-off between transforms: the forms
that were weighed, measured on the card.

    python3 chain_options.py

A developer's measurement, run from the repo's root on one NVIDIA GPU; no
entry point of the package uses it. Each option is
``fastecc_tpu_torch/csrc/gf.cuh`` or ``microbench.cu`` edited in a copy
under ``build/chain_options/`` and built alone with ``nvcc``:

  pkg       the package: gf.cuh mul_solinas (the product a * b in C,
            then REDC with the negated Montgomery factor in one asm
            block: lo << 20 and the add as one LEA whose carry rides into
            ~q, m >> 12 a multiply by 2^20, the borrow of hi - q read as
            d > hi, then a predicated select of p and an add), K15's
            register hand-off, and K15 held to two blocks an SM from
            c = 512 on;
  mad       mul_solinas with the fix-up d + k (2^32 - p), k = -[d > hi],
            as one multiply-add on the IMAD pipe;
  shf       mul_solinas with lo << 20 and m >> 12 as funnel shifts (shf),
            on the other pipe (mad and shf edit mul_solinas itself, so
            K15's GF32 transforms, which multiply with it, change too);
  plainc    mul_solinas as plain CUDA C (the same formulas), ptxas' own
            choice of instructions;
  gen_neg   the "generic" step (gf.cuh mul_generic, the textbook REDC)
            replaced by the generic REDC in the negated form:
            m = lo * p^-1 and q = (m * p) >> 32 as multiplies, then the
            package's d > hi and multiply-add fix-up;
  natural   K15 with the transforms handed over through shared memory:
            each transform's output stored back into the tile in natural
            order (two more barriers a transform), then read as the next
            transform's step 1;
  unbound   K15 with no bound on its blocks an SM at any length (the
            package holds it to two from c = 512 on, kFusedBoundLog);
  lb2_all   K15 held to two blocks an SM at every length.

Each option is held equal to its plain version: the chains of every
Solinas variant and "generic" on ``solinas_edge_inputs`` at depths 1 and 3
and on the reference's operands at depth 128, K15 at every c = 2 .. 2048
in both fields at depths 0-3 over 13 and 40 lanes. Then timed in turns
(CUDA events, ``chip_smoke.event_ms``), in the order listed and back:
the chains at the peaks' shape [131072, 128], depth 128 (the ``kernels``
row), K15 at the three fused configs (64 row tiles) at depths 2 and 4.
Prints each option's chain-loop instructions per step by pipe
(``sass_check.py``'s split: IMAD-class against the rest) and ptxas'
registers and spills for K15 at c >= 512.
"""

from __future__ import annotations

import collections
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
import sass_check
from fastecc_tpu_torch.fields import FIELDS
from fastecc_tpu_torch.kernels import _build
from fastecc_tpu_torch.kernels import microbench as mb
from fastecc_tpu_torch.kernels import ntt_mfa as m

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "fastecc_tpu_torch" / "csrc"
OUT = ROOT / "build" / "chain_options"

SELECT = ('"setp.gt.u32 w, d, %2;\\n\\t"\n'
          '      "selp.u32 k, -1048575, 0, w;\\n\\t"\n'
          '      "add.u32 %0, d, k;\\n\\t"')
SHIFTS = ('"mul.lo.u32 l, %1, 1048576;\\n\\t"',
          '"mul.hi.u32 s, m, 1048576;\\n\\t"')

FORMS = r'''
__device__ __forceinline__ uint32_t mul_solinas_c(uint32_t a, uint32_t b) {
  const uint32_t lo = a * b, hi = __umulhi(a, b);
  const uint32_t l = lo << 20, m = lo + l, s = m >> 12;
  const uint32_t q = m - s - (m < l ? 1u : 0u);
  const uint32_t d = hi - q;
  return d > hi ? d + kP32 : d;
}

__device__ __forceinline__ uint32_t mul_gen_neg(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("{\n\t"
      ".reg .u32 lo, hi, m, q, d, k;\n\t"
      "mul.lo.u32 lo, %1, %2;\n\t"
      "mul.hi.u32 hi, %1, %2;\n\t"
      "mul.lo.u32 m, lo, 1048577;\n\t"
      "mul.hi.u32 q, m, %3;\n\t"
      "sub.u32 d, hi, q;\n\t"
      "set.gt.u32.u32 k, d, hi;\n\t"
      "mad.lo.u32 %0, k, 1048575, d;\n\t"
      "}"
      : "=r"(r) : "r"(a), "r"(b), "r"(kP32));
  return r;
}
'''

HANDOFF = '''    fecc::reg_transform_regs<F, false, S>(y, tile, tws, t, l);
    fecc::static_for<S::A1>([&](auto i) {
      r[decltype(i)::value] = y[decltype(i)::value];
    });
  }'''
NATURAL = '''    fecc::reg_transform_regs<F, false, S>(y, tile, tws, t, l);
    fecc::static_for<S::A1>([&](auto i) {
      r[decltype(i)::value] = y[decltype(i)::value];
    });
    if (d + 1 == depth) break;
    __syncthreads();  // every thread has read its step-2 columns
    fecc::static_for<S::A1 / S::A2>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      fecc::static_for<S::A2>([&](auto k2c) {
        constexpr int k2 = decltype(k2c)::value;
        tile[(t + S::A2 * j + S::A1 * k2) * S::TL + l] =
            r[j * S::A2 + fecc::bitrev(k2, S::LA2)];
      });
    });
    __syncthreads();
    fecc::static_for<S::A1>([&](auto nc) {
      constexpr int n1 = decltype(nc)::value;
      r[n1 % kRho * S::A2 + fecc::bitrev(n1 / kRho, S::LA2)] =
          tile[(n1 * S::A2 + t) * S::TL + l];
    });
  }'''


def edit(src: str, old: str, new: str) -> str:
    assert src.count(old) >= 1, old
    return src.replace(old, new, 1)


def mad(gf: str, mbs: str) -> tuple[str, str]:
    return edit(gf, SELECT, '"set.gt.u32.u32 k, d, %2;\\n\\t"\n'
                '      "mad.lo.u32 %0, k, 1048575, d;\\n\\t"'), mbs


def shf(gf: str, mbs: str) -> tuple[str, str]:
    gf = edit(gf, ".reg .u32 l, m, nm, s, t, d, k;\\n\\t",
              ".reg .u32 z, l, m, nm, s, t, d, k;\\n\\t"
              '"\n      "mov.u32 z, 0;\\n\\t')
    gf = edit(gf, SHIFTS[0], '"shf.l.clamp.b32 l, z, %1, 20;\\n\\t"')
    return edit(gf, SHIFTS[1], '"shf.r.clamp.b32 s, m, z, 12;\\n\\t"'), mbs


def with_forms(gf: str) -> str:
    return edit(gf, "// The reference microbenchmark's", FORMS +
                "\n// The reference microbenchmark's")


def plainc(gf: str, mbs: str) -> tuple[str, str]:
    return with_forms(gf), edit(mbs, "return fecc::mul_solinas(y, z);",
                                "return fecc::mul_solinas_c(y, z);")


def gen_neg(gf: str, mbs: str) -> tuple[str, str]:
    return with_forms(gf), edit(mbs, "return fecc::mul_generic(y, z);",
                                "return fecc::mul_gen_neg(y, z);")


def natural(gf: str, mbs: str) -> tuple[str, str]:
    return gf, edit(mbs, HANDOFF, NATURAL)


def bound_from(log: int):
    return lambda gf, mbs: (gf, edit(mbs, "constexpr int kFusedBoundLog = 9;",
                                     f"constexpr int kFusedBoundLog = {log};"))


VARIANTS = {"pkg": lambda g, s: (g, s), "mad": mad, "shf": shf,
            "plainc": plainc, "gen_neg": gen_neg, "natural": natural,
            "unbound": bound_from(12), "lb2_all": bound_from(1)}
SOLINAS = ("solinas", "solinas-bcast", "solinas-masksel")


def ptxas(log: str, tag: str) -> None:
    name = None
    for line in log.splitlines():
        mm = re.search(r"Compiling entry function '(\S+)'", line)
        if mm:
            name = mm.group(1)
            continue
        km = name and re.search(r"fused_chain_kernel(?:_lb2)?ILi(\d)ELi(\d+)E",
                                name)
        if km and int(km.group(2)) >= 9 and ("Used" in line
                                             or "spill" in line):
            cs.say(f"[{tag}] K15 F{km.group(1)} LA{km.group(2)}: "
                   f"{line.split(':', 1)[-1].strip()}")


def build_variants() -> dict:
    gf0 = (CSRC / "gf.cuh").read_text()
    mb0 = (CSRC / "microbench.cu").read_text()
    procs = {}
    for name, fn in VARIANTS.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        gf, mbs = fn(gf0, mb0)
        (d / "gf.cuh").write_text(gf)
        (d / "microbench.cu").write_text(mbs)
        procs[name] = (d, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "microbench.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"{name} build:\n{log[-4000:]}")
        ptxas(log, name)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn in ("fecc_chain", "fecc_fused_chain"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, d / "lib.so")
    return libs


def pipes(lib_path: Path) -> None:
    """Per Solinas variant and generic: the chain loop's instructions per
    step, IMAD-class and the rest."""
    funcs = sass_check.functions(lib_path)
    for v, name in enumerate(mb._VARIANTS):
        if name not in SOLINAS + ("generic",):
            continue
        body = sass_check.loop_body(funcs[f"chain_kernel<{v}>"])
        split = sass_check.by_pipe(body)
        ops = collections.Counter(sass_check.opcode(t) for t in body)
        cs.say(f"[sass] {lib_path.parent.name} {name}: per step "
               + ", ".join(f"{k} {n / sass_check.STEPS_PER_ITER:.3f}"
                           for k, n in split.items())
               + f"; body {dict(ops.most_common())}")


def chain_call(lib, v, x, z, depth):
    out = torch.empty_like(x)

    def call():
        code = lib.fecc_chain(mb._VARIANT_CODE[v], x.data_ptr(), z.data_ptr(),
                              out.data_ptr(), x.shape[0], depth,
                              torch.cuda.current_stream().cuda_stream)
        cs.check(code == 0, f"fecc_chain returned {code}")
        return out
    return call


def fused_call(lib, field, x, depth):
    out = torch.empty_like(x)
    c = x.shape[0]
    tw = m._row_tw_on(field.name, c, False, str(x.device))

    def call():
        code = lib.fecc_fused_chain(0 if field.use_mont else 1, x.data_ptr(),
                                    out.data_ptr(), c, x.numel() // c,
                                    tw.data_ptr(), depth,
                                    torch.cuda.current_stream().cuda_stream)
        cs.check(code == 0, f"fecc_fused_chain returned {code}")
        return out
    return call


def turns(fns: dict, what: str) -> None:
    order = list(fns)
    ms = {}
    for k in order + order[::-1]:
        ms.setdefault(k, []).append(cs.event_ms(fns[k]))
    cs.say(f"[turns] {what}, ms in turns {order} then back: " + "; ".join(
        f"{k} {t[0]:.4f} / {t[1]:.4f}" for k, t in ms.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_options: no CUDA device", file=sys.stderr)
        return 2
    cs.say(cs.card_line())
    libs = build_variants()
    for name, (_, path) in libs.items():
        if name in ("pkg", "mad", "shf", "plainc", "gen_neg"):
            pipes(path)

    # equal to the plain versions
    ex, ez = mb.solinas_edge_inputs("cuda")
    x, z = mb.chain_inputs(4 * mb._TS, "cuda")
    for name, (lib, _) in libs.items():
        for v in SOLINAS + ("generic",):
            for xx, zz, depth in ((ex, ez, 1), (ex, ez, 3), (x, z, 128)):
                cs.check(torch.equal(chain_call(lib, v, xx, zz, depth)(),
                                     mb.chain_plain(xx, zz, v, depth)),
                         f"{name} {v} at depth {depth}")
    gen = torch.Generator(device="cuda").manual_seed(15)
    for field in FIELDS.values():
        for la in range(1, 12):
            for lanes in (13, 40):
                y = cs.rand_field(field.p, (1 << la, lanes), gen)
                for depth in range(4):
                    want = mb.fused_chain_plain(y, field, depth)
                    for name, (lib, _) in libs.items():
                        cs.check(torch.equal(
                            fused_call(lib, field, y, depth)(), want),
                            f"{name} K15 {field.name} c = {1 << la} "
                            f"depth {depth}")
    cs.say(f"[options] {sorted(libs)} == plain: the Solinas chains and "
           f"generic on the edge operands (depth 1, 3) and at depth 128, "
           f"K15 at every c, both fields, depths 0-3, 13 and 40 lanes")

    rows = 64 * 1024 * 1024 // (4 * mb._TL)
    x, z = mb.chain_inputs(rows, "cuda")
    lib = {k: v[0] for k, v in libs.items()}
    turns({**{f"{k} solinas": chain_call(lib[k], "solinas", x, z, 128)
              for k in ("pkg", "mad", "shf", "plainc")},
           "pkg generic": chain_call(lib["pkg"], "generic", x, z, 128),
           "gen_neg generic": chain_call(lib["gen_neg"], "generic", x, z,
                                         128)},
          f"chains [{rows}, 128] depth 128")
    turns({f"{k} {v}": chain_call(lib[k], v, x, z, 128)
           for v in ("solinas-bcast", "solinas-masksel")
           for k in ("pkg", "mad", "shf")},
          f"chains [{rows}, 128] depth 128")
    del x, z
    for key, cfg in mb._FUSED_CONFIGS.items():
        field = FIELDS[cfg["field_name"]]
        xf = mb.fused_inputs(field, cfg["c"], 64, "cuda")
        for depth in (2, 4):
            fns = {k: fused_call(lib[k], field, xf, depth)
                   for k in ("pkg", "natural", "unbound", "lb2_all")}
            for k in ("natural", "unbound", "lb2_all"):
                cs.check(torch.equal(fns["pkg"](), fns[k]()),
                         f"{k} != pkg at {key}")
            turns(fns, f"K15 {key} {tuple(xf.shape)} depth {depth}")
        del xf
    return 0


if __name__ == "__main__":
    sys.exit(main())
