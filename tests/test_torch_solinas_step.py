"""K14's Solinas steps against the reference, on the CPU, one PTX line at a
time.

``fastecc_tpu_torch/csrc/gf.cuh`` writes ``mul_solinas`` and
``mul_solinas_masksel`` as one inline-PTX block each (the carry flag
carries the REDC's borrows), and no card is here to run them. So this file
reads the asm text of both functions out of ``gf.cuh`` and runs it, line
by line, on a numpy model of each PTX instruction it uses: 32-bit wraps,
the carry flag that ``add.cc`` writes and ``addc`` reads, ``set``'s
all-ones mask, ``setp``'s predicate and ``selp``. An instruction the model
does not know fails the test, so a new sequence in the source needs its
model here. The result is held bit
for bit against the JAX package's ``gf.mont_mul(GF32, ...)`` (its Solinas
branch) and the masksel form against the reference microbenchmark's
``_mont_mul_masksel``, on ``microbench.solinas_edge_pairs`` (edge words,
zero low words, both sides of every conditional step) and on 2^16 seeded
random pairs. The kernels themselves are held against the plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from fastecc_tpu import fields as jfields
from fastecc_tpu import gf as jgf
from fastecc_tpu.kernels import microbench as ref
from fastecc_tpu_torch.fields import GF32
from fastecc_tpu_torch.interop import to_numpy_u32
from fastecc_tpu_torch.kernels import microbench as mb

GF_CUH = (Path(__file__).resolve().parents[1] / "fastecc_tpu_torch" / "csrc"
          / "gf.cuh")
M32 = np.uint64(0xFFFFFFFF)
STEPS = {"mul_solinas": lambda a, b: jgf.mont_mul(
             jfields.GF32, jnp.asarray(a), jnp.asarray(b)),
         "mul_solinas_masksel": lambda a, b: ref._mont_mul_masksel(
             jnp.asarray(a), jnp.asarray(b))}


# One function a PTX instruction: (sources..., carry flag in) -> (result,
# carry flag out). Values are numpy uint64 arrays holding u32 words; the
# carry flag is a bool array (CC.CF), written by add.cc and read by addc.
# Only what the steps use is modelled. sub.cc and subc are left out on
# purpose: ptxas 12.8 keeps CC.CF as the adder's carry, so subc after
# add.cc subtracts 1 - carry, and it folds a sub.cc of mul.hi's result
# into IMAD.HI with a wrong carry when the subtrahend is 0 (both measured
# on the H100, PERF.md section 6); a step that used them would fail
# here until modelled as the card runs them.

def _mul_lo(a, b, cf):
    return (a * b) & M32, cf          # a * b < 2^64: exact in uint64


def _mul_hi(a, b, cf):
    return (a * b) >> np.uint64(32), cf


def _mad_lo(a, b, c, cf):
    return (((a * b) & M32) + c) & M32, cf


def _add(a, b, cf):
    return (a + b) & M32, cf


def _add_cc(a, b, cf):
    s = a + b
    return s & M32, s > M32


def _addc(a, b, cf):
    return (a + b + cf.astype(np.uint64)) & M32, cf


def _not(a, cf):
    return a ^ M32, cf


def _and(a, b, cf):
    return a & b, cf


def _set_gt(a, b, cf):
    """set.gt.u32.u32: 0xFFFFFFFF where a > b, else 0."""
    return np.where(a > b, M32, np.uint64(0)), cf


def _setp_gt(a, b, cf):
    """setp.gt.u32: a predicate (a bool array)."""
    return a > b, cf


def _selp(a, b, w, cf):
    """selp.u32: a where the predicate w, else b."""
    return np.where(w, a, b), cf


PTX = {"mul.lo.u32": _mul_lo, "mul.hi.u32": _mul_hi, "mad.lo.u32": _mad_lo,
       "add.u32": _add, "add.cc.u32": _add_cc, "addc.u32": _addc,
       "not.b32": _not, "and.b32": _and, "set.gt.u32.u32": _set_gt,
       "setp.gt.u32": _setp_gt, "selp.u32": _selp}


def asm_lines(fn: str) -> list[tuple[str, list[str]]]:
    """The instructions of function ``fn``'s asm block in gf.cuh:
    [(mnemonic, [destination, sources...])]."""
    text = GF_CUH.read_text()
    body = text[text.index(f"uint32_t {fn}(uint32_t a, uint32_t b) {{"):]
    block = body[body.index("asm("):body.index('\n      : "=r"')]
    out = []
    for line in re.findall(r'"([^"]*)"', block):
        line = line.replace("\\n", "").replace("\\t", "").strip()
        if line in ("{", "}") or line.startswith(".reg"):
            continue
        op, args = line.rstrip(";").split(None, 1)
        out.append((op, [x.strip() for x in args.split(",")]))
    return out


def run_asm(fn: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """gf.cuh's ``fn`` on u32 arrays a, b, one PTX line at a time."""
    regs = {"%1": a.astype(np.uint64), "%2": b.astype(np.uint64)}
    cf = np.zeros(a.shape, bool)

    def value(x):
        if x in regs:
            return regs[x]
        return np.uint64(int(x, 0) & 0xFFFFFFFF)     # an immediate

    for op, (dst, *srcs) in asm_lines(fn):
        assert op in PTX, f"{fn}: no model of {op}"
        regs[dst], cf = PTX[op](*map(value, srcs), cf)
    return regs["%0"].astype(np.uint32)


def test_asm_is_what_the_model_runs():
    """Both steps are one straight-line block of known instructions ending
    in the output %0, and the carry flag is read (addc) only right after
    an add.cc wrote it, with no other instruction that touches it
    between."""
    for fn in STEPS:
        lines = asm_lines(fn)
        assert lines and lines[-1][1][0] == "%0", fn
        written = False
        for op, _ in lines:
            assert op in PTX, (fn, op)
            assert written or op != "addc.u32", (fn, "CF read before set")
            written = op == "add.cc.u32" or (written and op != "addc.u32")


@pytest.mark.parametrize("fn", list(STEPS))
def test_step_on_edge_pairs(fn):
    """Bit for bit against the reference on every edge pair."""
    a, b = mb.solinas_edge_pairs()
    np.testing.assert_array_equal(run_asm(fn, a, b),
                                  np.asarray(STEPS[fn](a, b)), err_msg=fn)


@pytest.mark.parametrize("fn", list(STEPS))
def test_step_on_random_pairs(fn):
    """Bit for bit against the reference on 2^16 seeded random pairs."""
    rng = np.random.default_rng(0x50115 + len(fn))
    a, b = (rng.integers(0, GF32.p, 1 << 16, dtype=np.uint64).astype(
        np.uint32) for _ in range(2))
    np.testing.assert_array_equal(run_asm(fn, a, b),
                                  np.asarray(STEPS[fn](a, b)), err_msg=fn)


def test_step_chains_like_the_reference():
    """Three dependent steps (the chain's y = step(y, z)) on the edge
    pairs: each output is a canonical residue the next step takes."""
    a, b = mb.solinas_edge_pairs()
    for fn, step in STEPS.items():
        y, want = a, jnp.asarray(a)
        for _ in range(3):
            y, want = run_asm(fn, y, b), step(want, b)
        assert int(y.max()) < GF32.p
        np.testing.assert_array_equal(y, np.asarray(want), err_msg=fn)


def test_edge_pairs_reach_every_corner():
    """The edge pairs hold 0, 1, p - 1 and p - 2 on each side, a product
    with a zero low word, and both outcomes of each conditional step of
    both REDC forms (the reference's and the kernel's)."""
    a, b = mb.solinas_edge_pairs()
    assert len(a) == len(b) <= mb._TS
    assert int(a.max()) < GF32.p and int(b.max()) < GF32.p
    for w in (0, 1, GF32.p - 1, GF32.p - 2):
        assert (a == w).any() and (b == w).any(), w
    t = a.astype(np.uint64) * b.astype(np.uint64)
    lo, hi = t & M32, t >> np.uint64(32)
    assert ((lo == 0) & (t != 0)).any()
    sh = (lo << np.uint64(20)) & M32
    m = (lo + sh) & M32
    carry = m < sh
    borrow = hi < m - (m >> np.uint64(12)) - carry
    mr = (np.uint64(0) - (lo + (lo << np.uint64(20)))) & M32
    under = mr < ((mr & np.uint64(0xFFF)) << np.uint64(20))
    mp_hi = (mr - (mr >> np.uint64(12)) - under) & M32
    t2 = (hi + (lo != 0) + np.uint64((1 << 32) - GF32.p)) & M32
    wrap = ((mp_hi + t2) & M32) < t2
    for flag in (carry, borrow, under, wrap):
        assert flag.sum() >= 40 and (~flag).sum() >= 40


def test_edge_inputs_place_the_pairs():
    """solinas_edge_inputs puts pair i at x[i, 0] and along row i of z,
    every word below p, [512, 128] as the chain wants."""
    a, b = mb.solinas_edge_pairs()
    x, z = (to_numpy_u32(t) for t in mb.solinas_edge_inputs("cpu"))
    assert x.shape == z.shape == (mb._TS, mb._TL)
    np.testing.assert_array_equal(x[:len(a), 0], a)
    np.testing.assert_array_equal(z[:len(b)], np.repeat(b[:, None], mb._TL,
                                                        axis=1))
    assert int(x.max()) < GF32.p and int(z.max()) < GF32.p
