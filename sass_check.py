"""What the compiler made of the kernels, read with ``cuobjdump -sass``.

    python3 sass_check.py --compare PARENT_ROOT
    python3 sass_check.py --ops
    python3 sass_check.py --count PREFIX

A developer's check of the kernel library, run from the repo's root; no
entry point of the package uses it.

``--compare`` builds the kernel library of the checkout at PARENT_ROOT
(its own ``_build``) and this one, and compares every kernel present in
both, instruction for instruction, keyed by kernel and template arguments
(the anonymous namespace's mangled prefix differs between builds).

``--ops`` prints, for each K14 variant, the instructions of its chain
loop's body by opcode and by pipe, and for the elementwise variants the
count per step (the body holds kChainUnroll * kIlp = 32 steps and the
loop's own control): the check that the compiler kept `depth` dependent
steps, the source of the op counts in
``fastecc_tpu_torch/utils/profiling.py``, and what a step asks of each
of Hopper's two integer pipes (IMAD-class instructions issue on one, the
rest on the other, each at half the issue rate). For each K15
instantiation (``fused_chain_kernel<F,LA>``, ``_lb2`` from c = 512 on)
it prints the loop body (one transform) by pipe and per element of a
thread's column (A1 of them).

``--count`` prints, for each kernel whose key starts with PREFIX (e.g.
``col_kernel<0,9,``), its SASS instruction count and its most common
opcodes. The register-stage kernels (csrc/col.cu, csrc/row.cu) are
straight-line, so the count is what each thread issues for its
elements: the measure of how far they are issue-bound.

Needs ``cuobjdump`` (beside ``nvcc``) and nothing else: no card.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

from fastecc_tpu_torch.kernels import _build
from fastecc_tpu_torch.kernels.microbench import _VARIANTS

# every kernel of the library, so that no key carries the anonymous
# namespace's build-specific prefix ("chain_kernel" after the two names
# that contain it)
_BASES = ("fused_chain_kernel_lb2", "fused_chain_kernel",
          "chain_tile_kernel", "chain_kernel",
          "copy_kernel", "row_sel_kernel_lb2",
          "row_sel_kernel", "row_post_kernel_lb2", "row_post_kernel",
          "row_wire16_kernel", "row_kernel", "col_kernel",
          "pair_lanes_wire16_kernel", "pair_lanes_kernel_lb2",
          "pair_lanes_kernel")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRA = re.compile(r"\bBRA\b[^`(0-9]*`?\(?(\.L_x_\d+|0x[0-9a-f]+)")
# csrc/microbench.cu: steps in one iteration of an elementwise chain loop
STEPS_PER_ITER = 8 * 4


def cuobjdump() -> str:
    path = Path(_build.nvcc()).parent / "cuobjdump"
    if not path.exists():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({path})")
    return str(path)


def _key(name: str) -> str:
    """kernel<template args> for a mangled name, e.g. col_kernel<0,9,1,0>."""
    for base in _BASES:
        i = name.find(base)
        if i >= 0:
            rest = name[i + len(base):]
            args = re.match(r"I((?:Li-?\d+E)+)E", rest)
            targs = re.findall(r"Li(-?\d+)E", args.group(1)) if args else []
            return f"{base}<{','.join(targs)}>"
    return name


def functions(lib: Path) -> dict[str, list[tuple[int, str]]]:
    """{kernel key: [(address, instruction text)]} of a library."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    pending: list[str] = []
    labels: dict[str, dict[str, int]] = {}
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _key(m.group(1))
            funcs[cur] = []
            labels[cur] = {}
            continue
        m = _LABEL.match(line)
        if m and cur:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m and cur:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            funcs[cur].append((addr, m.group(2).strip()))
    # branch targets given as labels become addresses
    def resolve(k, mm):
        lab = mm.group(1)
        if not lab.startswith(".L"):
            return mm.group(0)
        return mm.group(0).replace(lab, hex(labels[k][lab]))
    for k, instrs in funcs.items():
        funcs[k] = [(a, _BRA.sub(lambda mm: resolve(k, mm), t))
                    for a, t in instrs]
    return funcs


def loop_body(instrs: list[tuple[int, str]]) -> list[str]:
    """The instructions of the largest backward-branch range (the
    kernel's main loop), branch included."""
    best: list[str] = []
    for i, (addr, text) in enumerate(instrs):
        m = _BRA.search(text)
        if not m or not m.group(1).startswith("0x"):
            continue
        target = int(m.group(1), 16)
        if 0 <= target <= addr:
            body = [t for a, t in instrs[:i + 1] if a >= target]
            if len(body) > len(best):
                best = body
    return best


def opcode(text: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]


def by_pipe(body: list[str]) -> dict[str, int]:
    """Instructions by Hopper integer pipe: "imad" (IMAD, IMAD.WIDE,
    IMAD.HI, IMAD.SHL, IMAD.MOV, ...) and "other" (IADD3, LOP3, SHF,
    ISETP, SEL, PRMT and the rest, loads, stores and branches included)."""
    imad = sum(opcode(t).startswith("IMAD") for t in body)
    return {"imad": imad, "other": len(body) - imad}


def compare(parent_root: Path) -> dict:
    """Build both libraries; per kernel of both, identical or not."""
    code = ("from fastecc_tpu_torch.kernels import _build; "
            "print(_build.build().path)")
    parent_lib = Path(subprocess.run(
        [sys.executable, "-c", code], cwd=parent_root, check=True,
        capture_output=True, text=True).stdout.strip().splitlines()[-1])
    old, new = functions(parent_lib), functions(_build.build().path)
    shared = sorted(set(old) & set(new))
    differ = [k for k in shared if [t for _, t in old[k]] !=
              [t for _, t in new[k]]]
    return {"compared": len(shared), "identical": len(shared) - len(differ),
            "differ": differ, "only_parent": sorted(set(old) - set(new)),
            "only_new": sorted(set(new) - set(old))}


def chain_ops() -> dict:
    """Per K14 variant: its chain loop's body by opcode and by pipe, and
    for the elementwise variants the instructions per step; per K15
    instantiation its loop body (one transform) by pipe, and per element
    of a thread's column."""
    funcs = functions(_build.build().path)
    rows = {}
    for v, name in enumerate(_VARIANTS):
        key = next((k for k in (f"chain_kernel<{v}>",
                                f"chain_tile_kernel<{v}>") if k in funcs),
                   None)
        if key is None:
            rows[name] = None
            continue
        body = loop_body(funcs[key])
        hist = collections.Counter(opcode(t) for t in body)
        row = {"kernel": key, "body": len(body), "pipes": by_pipe(body),
               "ops": dict(sorted(hist.items(), key=lambda kv: -kv[1]))}
        if key.startswith("chain_kernel"):
            row["per_step"] = round(len(body) / STEPS_PER_ITER, 3)
            row["per_step_by_pipe"] = {
                k: round(n / STEPS_PER_ITER, 3)
                for k, n in row["pipes"].items()}
        rows[name] = row
    for key in sorted(k for k in funcs if k.startswith("fused_chain_kernel")):
        targs = key[key.index("<") + 1:-1].split(",")
        if len(targs) != 2:     # an older library's K15 (no length)
            continue
        la = int(targs[1])
        body = loop_body(funcs[key])
        a1 = 1 << ((la + 1) // 2)
        rows[key] = {"kernel": key, "body": len(body), "pipes": by_pipe(body),
                     "per_element": round(len(body) / a1, 3),
                     "instructions": len(funcs[key])}
    return rows


def counts(prefix: str) -> dict:
    """Per kernel whose key starts with ``prefix``: its instruction count
    and its ten most common opcodes."""
    funcs = functions(_build.build().path)
    return {k: {"instructions": len(v), "ops": dict(collections.Counter(
        opcode(t) for _, t in v).most_common(10))}
        for k, v in sorted(funcs.items()) if k.startswith(prefix)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sass_check.py")
    ap.add_argument("--compare", metavar="PARENT_ROOT", default=None)
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--count", metavar="PREFIX", default=None)
    args = ap.parse_args(argv)
    if args.compare:
        print(json.dumps({"sass_compare": compare(Path(args.compare))}))
    if args.ops:
        for name, row in chain_ops().items():
            print(json.dumps({"variant": name, **(row or {})}))
    if args.count is not None:
        for key, row in counts(args.count).items():
            print(json.dumps({"kernel": key, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
