"""Profiling and the roofline model: the port's counterpart of
``utils/profiling.py``.

:func:`trace` records a ``torch.profiler`` trace of the card (a Chrome
trace, viewable in Perfetto) and :func:`scope` names a region in it; the
port's own regions are named ``fecc.*`` (its entries, passes and the GF16
wire join) and cost nothing measurable while no profiler records. The
roofline functions give a speed-of-light time for a pipeline config: the
larger of its device-memory traffic over the memory rate and its integer
operations over the card's integer rates. Signatures, byte accounting
and output keys are the reference's; the peaks and the op counts are the
H100's and the port's kernels' own.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch

# The published rates of one H100 SXM, the default peaks: 3.35 TB/s of
# HBM3 (NVIDIA's data sheet) and 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# = 1.67e13 32-bit integer operations per second for multiplies and other
# ops alike (the Hopper architecture white paper's SM layout). Shares are
# stated against these; `kernels.microbench.measure_peaks()` measures the
# card's own and passes as ``peaks=`` (``cli roofline --peaks-json``).
H100_PUBLISHED_PEAKS = {
    "hbm_stream_gbps": 3350.0,
    "raw_mul_gops": 132 * 64 * 1.98,
    "raw_add_gops": 132 * 64 * 1.98,
}


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the card's kernels and the host's calls under
    ``torch.profiler``; on exit writes ``log_dir/trace.json`` (Chrome
    trace format):

        with profiling.trace("traces/encode"):
            fence(rs.encode_parity(data, GF32))
    """
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# What :func:`scope` returns while no profiler records: one shared context
# that does nothing (a ``record_function`` costs microseconds even then).
_OFF = contextlib.nullcontext()


def scope(name: str):
    """A named region in the trace: ``with profiling.scope('ntt_f'):``.
    It records only while a ``torch.profiler`` session does (:func:`trace`,
    or any ``torch.profiler.profile``): a host range in the same trace as
    the card's kernels, on the profiler's clock. The range is a plain host
    op (``_RecordFunctionFast``), not a ``record_function`` annotation, for
    which the profiler would also draw a span on the card's timeline over
    the work launched directly inside it. Otherwise it is the shared null
    context :data:`_OFF`."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


# Integer instructions per primitive as the passes issue them (csrc/gf.cuh,
# csrc/regstages.cuh), as (multiplies, other ops), counted from the SASS of
# K14's variants (`python3 sass_check.py --ops`: the body of each chain
# loop holds 32 steps) and, for add and sub, which no
# variant runs alone with two varying operands, from the source the same
# way (one instruction per add, compare or predicated fix-up; the
# compiler's three-input IADD3 takes a + b + bias in one):
#   mul_full<GF32> (the Solinas REDC the passes call): 1 mul + 7 ops
#     (IMAD.WIDE.U32 gives both words of a*b; the REDC is shifts and adds)
#   mul_tw<GF16> (stage tables)                      : 1 mul + 5 ops
#   mul_full<GF16> (four-step, coset, decode tables) : 1 mul + 10 ops
#   add<GF32> : 4 ops   sub<GF32> : 3 ops
#   add<GF16> : 3 ops   sub<GF16> : 3 ops
# A radix-4 butterfly is 4 mulmods + 4 adds + 4 subs per 4 elements and 2
# stages (8 element-stages). Index arithmetic, shared-memory traffic and
# barriers are not counted. This is a one-pipe model, not a lower bound:
# it prices every non-multiply at `raw_add_gops`, one pipe's rate, while
# Hopper issues IADD3/LOP3 and IMAD-pipe adds on two pipes at once (the
# `gf16-tw` chain runs 1.98x the published INT32 rate, PERF.md), so
# `t_compute_bound_s` can be up to 2x the least time.
_MULMOD_OPS = {"GF32": (1, 7), "GF16": (1, 10)}
_TW_OPS = {"GF32": (1, 7), "GF16": (1, 5)}
_ADD_OPS = {"GF32": 4, "GF16": 3}
_SUB_OPS = {"GF32": 3, "GF16": 3}
_STAGE_OPS = {                      # per element-stage: (muls, other ops)
    f: (4 * _TW_OPS[f][0] / 8,
        (4 * _TW_OPS[f][1] + 4 * _ADD_OPS[f] + 4 * _SUB_OPS[f]) / 8)
    for f in ("GF32", "GF16")
}


def pipeline_roofline(field_name: str, transform_len: int, lanes: int,
                      n_transforms: int = 2,
                      extra_mulmods_per_elem: float = 3.0,
                      hbm_passes: float = 4.0,
                      out_bytes: int | None = None,
                      extra_vpu_ops_per_elem: float = 0.0,
                      peaks: dict | None = None) -> dict:
    """Speed-of-light time for a fused-transform pipeline (the
    reference's name; a one-pipe model, see the op table above): the op
    counts priced at the multiply and add rates of ``peaks``, against
    ``hbm_passes`` read+write passes over the [transform_len, lanes] u32
    array at its memory rate.

    ``extra_mulmods_per_elem`` covers the non-butterfly multiplies per
    element (four-step twiddle, coset multiply, decode tables);
    ``extra_vpu_ops_per_elem`` plain integer epilogue work (the wire
    passes' split, repack and escape ops), priced at the add rate.
    """
    peaks = peaks or H100_PUBLISHED_PEAKS
    elems = transform_len * lanes
    word_bytes = 4
    t_mem = hbm_passes * 2 * elems * word_bytes / (
        peaks["hbm_stream_gbps"] * 1e9)
    r_mul = peaks["raw_mul_gops"] * 1e9
    r_add = peaks["raw_add_gops"] * 1e9
    muls, others = _STAGE_OPS[field_name]
    stages = n_transforms * math.log2(transform_len)
    t_stages = elems * stages * (muls / r_mul + others / r_add)
    mm, mo = _MULMOD_OPS[field_name]
    t_extra = elems * extra_mulmods_per_elem * (mm / r_mul + mo / r_add)
    t_extra += elems * extra_vpu_ops_per_elem / r_add
    t_compute = t_stages + t_extra
    t = max(t_mem, t_compute)
    ob = out_bytes if out_bytes is not None else elems * word_bytes
    return {
        "t_memory_bound_s": t_mem,
        "t_compute_bound_s": t_compute,
        "t_stage_compute_s": t_stages,
        "t_extra_mulmod_s": t_extra,
        "bound": "memory" if t_mem > t_compute else "compute",
        "speed_of_light_s": t,
        "speed_of_light_gbps": ob / t / 1e9,
    }


def ntt_roofline(n: int, lanes: int, peaks: dict | None = None,
                 field_name: str = "GF32"):
    """One four-step NTT: 2 read+write passes (K1, K3) and 1 extra
    multiply per element (the four-step twiddle; the inverse's 1/N rides
    the same table). GB/s counts array bytes once."""
    return pipeline_roofline(field_name, n, lanes, n_transforms=1,
                             extra_mulmods_per_elem=1.0, hbm_passes=2.0,
                             peaks=peaks)


def decode_roofline(n: int, lanes: int, peaks: dict | None = None,
                    field_name: str = "GF32", seam: bool = True):
    """Prepared erasure decode (decode.decode_prepared): two n-point
    transforms with 4 extra multiplies per element (two four-step
    twiddles, the locator prologue, the Forney epilogue; the derivative
    multiply is left out, as in the reference's count). ``seam``
    prices the 3-pass pair (K5 -> K6 -> K7-sel), ``seam=False`` 4 staged
    passes. GB/s counts codeword bytes once."""
    return pipeline_roofline(field_name, n, lanes, n_transforms=2,
                             extra_mulmods_per_elem=4.0,
                             hbm_passes=3.0 if seam else 4.0,
                             peaks=peaks)


def encode_blocks_roofline(n_blocks: int, block_bytes: int = 4096,
                           field_name: str = "GF16", fused: bool = True,
                           peaks: dict | None = None) -> dict:
    """Wire-domain RS encode (rs.encode_blocks): the field-domain pair
    plus the pack and serialize traffic, in the reference's accounting
    per wire unit of the [k, lanes] field pipeline:

    GF16 (W = B/2 wire words, elements = k*W): ``fused=True`` (the wire
    pair) 20.75 bytes/word, with ~6 extra integer ops/word for the split,
    re-pack and escape bits; ``fused=False`` (pack -> encode_parity ->
    serialize) 24 + 6 + 6.25 = 36.25 bytes/word.

    GF32 (Wd = B/4 data words, E = Wd + ceil(Wd/16) lanes with the escape
    lanes): pack does not fuse, so only ``fused=False``: pack (4Wd read +
    4E written) + 24E (the field pair).

    GB/s convention: codeword wire bytes = n_blocks * block_bytes.
    """
    k = n_blocks // 2
    wire_ops = 0.0
    if field_name == "GF16":
        w = block_bytes // 2
        lanes = w
        per_word = 20.75 if fused else 36.25
        wire_ops = 6.0 if fused else 0.0
        total_bytes = k * w * per_word
    else:
        if fused:
            raise ValueError("the GF32 wire pipeline has no fused variant")
        wd = block_bytes // 4
        lanes = wd + -(-wd // 16)
        total_bytes = k * (28.0 * lanes + 4.0 * wd)
    base = pipeline_roofline(
        field_name, k, lanes, n_transforms=2, extra_mulmods_per_elem=3.0,
        hbm_passes=total_bytes / (2.0 * k * lanes * 4.0),
        out_bytes=n_blocks * block_bytes,
        extra_vpu_ops_per_elem=wire_ops, peaks=peaks)
    base["hbm_bytes"] = total_bytes
    base["fused"] = fused
    return base


def decode_blocks_roofline(n_blocks: int, block_bytes: int = 4096,
                           field_name: str = "GF16",
                           peaks: dict | None = None) -> dict:
    """Wire-domain decode (decode.decode_wire_parts, all data erased at
    rate 1/2): two k-point transforms over [k, E] and 3 extra multiplies
    per element, with the reference's bytes per element of the field
    array: the 3-pass pair (24) plus GF16's deserialize (2 + 4) and
    recombine (4 + 2) = 36; GF32's deserialize is a view, its recombine
    4 + 4, so 32.

    GB/s convention: recovered data bytes = k * block_bytes.
    """
    k = n_blocks // 2
    if field_name == "GF16":
        w = block_bytes // 2
        lanes = w
        per_elem = 36.0
    else:
        wd = block_bytes // 4
        lanes = wd + -(-wd // 16)
        per_elem = 32.0
    total_bytes = k * lanes * per_elem
    base = pipeline_roofline(
        field_name, k, lanes, n_transforms=2,
        extra_mulmods_per_elem=3.0,
        hbm_passes=total_bytes / (2.0 * k * lanes * 4.0),
        out_bytes=k * block_bytes, peaks=peaks)
    base["hbm_bytes"] = total_bytes
    return base


def encode_roofline(n_blocks: int, lanes: int, peaks: dict | None = None,
                    field_name: str = "GF32", seam: bool = True):
    """RS encode (the coset pair iNTT_k + coset NTT_k, 3 extra multiplies
    per element: two four-step twiddles and the coset multiply). With
    ``seam`` (the rate-1/2 path, K1 -> K2 -> K3) the two transforms take
    3 read+write passes; ``seam=False`` prices 4 staged passes. GB/s is in
    codeword bytes (n * lanes * 4)."""
    k = n_blocks // 2
    return pipeline_roofline(
        field_name, k, lanes, n_transforms=2, extra_mulmods_per_elem=3.0,
        hbm_passes=3.0 if seam else 4.0,
        out_bytes=n_blocks * lanes * 4, peaks=peaks)
