#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``fastecc_tpu_torch`` (never JAX or ``fastecc_tpu``) through its
main path on the card and fails loudly on any fault. Phases:

  1. build   — compile the Hopper kernels from ``fastecc_tpu_torch/csrc``;
  2. kernels — each of K1-K12 (K7 in both its forms) against its plain
               PyTorch version on the card, at the shapes phases 4-12 give
               it (on a 16-lane slice) and at small orders with a ragged
               lane count, both fields, with random prepared tables (GF16
               ones holding 0x10000) and masks about half set, and K10 on
               outputs that are ~90% 0x10000 (saturated bitmap words);
               K3, K7 and K7-sel at every A = 2 .. 1024 in both
               directions over 13 and 40 lanes (1088 at A >= 512), K7-sel
               with masks about half set and its original both a tensor
               of its own and the pass's input, K7 also on a view 4 bytes
               past a 16-byte boundary, K1, K4 and K5 (forward, inverse
               scaled and not), K2 and K6 likewise on [A, 4, L]; K8 at
               every C1 = 2 .. 1024 on [C1, 4, Wu] random 32-bit pairs
               over Wu = 8, 40, 1024 and on a view 4 bytes past a
               16-byte boundary; K11 at k
               = 32, 2^10, 2^13
               over 1088 and 13 lanes in both fields, K12 at those k over
               Wu = 8, 40, 1024 and on dense escapes (the escape counts
               printed) and at every k = 4 .. 2^13 over Wu = 8, 40, 1024,
               K9 at every R1 = 2 .. 1024 over Wu = 8, 16, 40; K10 at
               every A = 2 .. 1024 on [A, 2, Wu] over Wu = 8, 40 and 1032
               (a ragged last lane tile), on views 4 bytes past a 16-byte
               boundary and on dense escapes at A = 1024 (TL = 16) against
               the plain version and the expected words; K11 at every
               k = 4 .. 2^13 in both fields over 13
               and 1088 lanes and on a view 4 bytes past a 16-byte
               boundary; bit-exact (``torch.equal``, tolerance 0: exact
               integer arithmetic);
  3. golden  — the JAX package's pinned SHA-256 digests (codewords of
               tests/test_rs.py, GF32 wire blob of tests/test_wire_golden.py)
               reproduced through the kernels;
  4. encode  — rate-1/2 GF32 encode at 2^20 source+parity blocks of
               1024 u32 lanes (k = 2^19, 4 KB blocks), the first and the
               last 8 lanes (first and last lane tile of every pass)
               checked against the plain staged transforms; median of 5
               timed calls; where build/parent holds an earlier checkout
               of the package, its K3, K1 and K2 on the same tensors and
               its K3 and K1 at the shapes the decode tables give them
               (held equal and timed beside this tree's, in turns); then
               a rate-1/4 encode (k = 2^18,
               n = 2^20), the path that runs K4, checked the same way,
               and the parent's K4 on its tensor;
  5. ntt     — the 2^20-point forward NTT over 512 lanes, first and last
               8 lanes checked against the plain staged transform; the
               parent's K1 on its tensor, as in phase 4;
  6. wire    — GF32 encode_blocks on 2^14 random 4 KB blocks, checked
               against encode_parity of the packed data, and its first
               and last 8 lanes (the ragged edge at 1088) against the
               plain staged transforms;
  7. wire16  — the reference bench's GF16 wire encode (bench.py:244):
               k = 2^13 blocks of 64 KB, encode_blocks_gf16_parts (K8 ->
               K9 -> K10) against the generic route on the card (pack_data
               -> encode_parity on K1 -> K2 -> K3 -> serialize_parity) on
               every lane, with escapes present, and its first and last 8
               lanes against the plain staged transforms; median of 5 timed
               calls (wire GB/s = n * B / time); the parent's K8, K9 and
               K10 on their tensors, as in phase 4; then encode_blocks at
               B = 4096, bytes against the generic route's;
  8. decode  — the reference bench's decode (bench.py:184): GF32,
               n = 2^20, k = 2^19, 512 lanes, the codeword from rs.encode
               on the card with e = 2^19 random erasures overwritten with
               garbage; tables from prepare_decode_tables (the device
               locator, timed), then decode_prepared (K5 -> K6 -> K7-sel)
               checked against the codeword on all 512 lanes, and the
               merge=False form (K7) at the erased rows; median of 5
               timed calls; K3 timed on K7-sel's tensor beside it; where
               build/parent holds an earlier checkout, its K5, K6, K7 and
               K7-sel on the same tensors and at decode_blocks' 2^13 pair
               shapes, and its K5 at the all-device decode's 2^13 single
               transforms (held equal and timed beside this tree's, in
               turns);
  9. decode_small — BASELINE.json:10 as users meet it: the all-device
               decode at n = 2^13, e = 2^12, 1024 lanes; decode_blocks
               over exactly k of 2^13 4 KB blocks (data and parity mixed,
               one all-0xFF block); decode_wire_parts (GF32, n = 2^18,
               4 KB blocks) against the raw blocks' u32 image;
 10. extras  — verify_codeword on phase 4's full-width GF32 codeword
               (True, then False after one word changes);
               update_parity_multi over three blocks at that width against
               a re-encode; encode_parity_batch against per-stripe calls;
               encode_parity_stream and decode_stream on host arrays
               against one call; each timed;
 11. lanes   — the one-pass lanes pair, switched on
               (``ntt_mfa.LANES_PAIR_ENABLED``) around these runs: the GF32
               batch encode of 64 stripes of 2^10 + 2^10 4 KB blocks
               (BASELINE.json:7's shape, 65,536 lanes) and encode_parity at
               k = 2^13 x 1024 lanes (K11), the GF32 wire decode at n = 2^13
               (K11 with the inverse seed), the GF16 wire encode at 2^13 x
               64 KB blocks and GF16 encode_blocks at 2^13 x 4 KB blocks
               (K12; BASELINE.json:9); each against the same call with the
               flag off (the three-pass route) on every lane, the batch and
               k = 2^13 also on their edge lanes against the plain staged
               transforms; median of 5 calls of both routes at each shape;
               the parent's K11 on the batch's [2^10, 65536] and its K12
               on the GF16 wire encode's pairs, as in phase 4; then each
               route's kernels on 128 MiB at k = 2^10 .. 2^13
               (GF32 and the GF16 wire pair), held equal and timed;
 12. errors  — unknown-position error correction: correct_errors on the
               full-width GF32 codeword (n = 2^20, 1024 lanes) with 16
               corrupted rows (8 replaced, 8 with one word of one lane + 1)
               and a fixed entropy, then with 2^12 known erasures besides;
               a clean codeword and corruption beyond (n-k)/2 at n = 2^13;
               decode_blocks(check=True) at n = 2^13 (BASELINE.json:10)
               over k + 64 survivors of which 16 lie; locate_errors and
               correct_errors timed, the phase's peak device memory;
 13. storage — the file layer on the card (storage, the native host
               library, built and checked loaded first, and the CLI's file
               commands), in temporary directories (TMPDIR) deleted after
               use, data from the seeded card generator, every depth cut
               by STORAGE_DEPTH_CUT halvings for the time limit (the cuts
               printed; the full sizes below): a GF32 file of 1 GiB in 4
               KB blocks (k = 2^18, n = 2^19 block files) encoded with
               max_resident 256 MiB (several word chunks), the .par
               files' SHA-256 against
               rs.encode_blocks of the whole file in device memory; n - k
               random files deleted and recover_file's SHA-256 against the
               source; repair of the lost files; 16 blocks (8 data, 8
               parity) changed under forged manifest CRCs: check_file
               locates them, recover_file(repair=True, check=True)
               restores them, check_file reads clean; GF16 at its capacity
               (k = 2^15, 128 MiB) encoded (parity against encode_blocks'
               wire pair) and recovered at the largest loss, with one
               profiled encode_file_stream (the device-busy share); a
               striped GF32 file of 2 x 2^16 + 1 blocks (stripes of 2^16,
               the last of one block): encode, recover with stripe 1 at its
               largest loss, a read across the stripe seam, an update of 3
               blocks and a recover of the updated file; then python -m
               fastecc_tpu_torch.cli encode, recover (half the files lost)
               and check on a 64 MiB file, as subprocesses with no
               --device. Per operation: wall, MB/s of file bytes, bytes
               written to disk; for the encode the device stage and the
               host emission apart; first, the microseconds to write and
               to read one 4 KB block file there. The GF32 file is also
               halved while the disk's free space cannot hold ~6.5x it;
 14. parallel — the sharded codec (fastecc_tpu_torch.parallel) on worlds
               of ranks sharing the card over Gloo (2x1, 4x1, 2x2; NCCL
               refuses two ranks of one communicator on one GPU) and a
               one-rank NCCL world (the passthrough), each started by
               parallel._worker.launch: the GF32 encode at k = 2^19, n =
               2^20, 1024 lanes (BASELINE.json:11), the GF16 encode at
               k = 2^15 x 1024, ntt_sharded at 2^20 x 512 forward and
               inverse, ntt_sharded_overlap (chunks 2), output_transposed
               and input_transposed once each at that shape, and
               decode_sharded at n = 2^20, e = 2^19, 512 lanes; each rank
               draws its inputs from the seeds and hashes its output
               shard against the SHA-256 of its slice of the single-card
               port (rs.encode_parity, ntt.ntt_auto, decode.decode_prepared
               on the card); the exchanges per call checked (3, 4, 4, 2 at
               each transposed end, 6 for two chunks), the median of 3
               timed calls, rank 0's profile of one 2x1 encode, the ranks'
               launches (K1 and K3 must launch) added to the path's;
               PARALLEL_WORLDS sets each world's depth cut (printed); then
               python -m fastecc_tpu_torch.cli scaling --op encode
               --devices 4 --lg-k 19 --lanes 256 --iters 2 and scaling
               --procs 4 --update-baseline into a temporary file, rows
               parsed and checked;
 15. peaks   — the microbenchmark kernels against their plain versions,
               bit-exact: K13 (the copy) at ragged sizes (around a
               block's span) and unaligned, K14
               (the chains) for every variant at depth 3 and at its default
               depth on four 512-row tiles, and the Solinas family on the
               edge operands of microbench.solinas_edge_pairs at depths 1,
               3 and 128, K15 (the fused chains) on the three fused configs
               at one and two row tiles and at every c = 2 .. 2048 in both
               fields over 13 and 40 lanes, depths 0-3; then
               microbench.measure_peaks() at the reference's full sizes (a
               1024 MiB copy, 64 MiB chains, 64 row tiles), printed as one
               JSON line; then each kernel again at those sizes against
               its plain version (the 256 MiB and 1 GiB copies, every
               variant on 64 MiB at its default depth, every fused config
               on 64 row tiles), timed there, with torch's copy_ as K13's
               library time (and, where build/parent holds an earlier
               checkout, its K13, its K14 solinas, generic, raw-mul and
               raw-add chains and its K15 at depths 2 and 4 beside this
               tree's, in turns); and profiling.encode_roofline(2^20, 1024)
               under the published and the measured peaks beside phase
               encode's time.

Launch counts are reset to 0 before each main-path run (phases 4-15) and
read right after it; each run must launch every kernel of its path (in
phase 14 each rank counts its own and the phase adds them up). Near
the end come the launches by path, one detail line per kernel (source,
the TPU kernel it replaces, the shape it was timed at), a JSON object
with, per kernel, its launches, its time at the main-path shape, the
plain version's time, the library call's where one computes the same
function, and the bound (the larger of bytes over the memory rate and
integer multiplies over the multiply rate), then the card's name and
power limit; the last line is the {"ok": true, ...} device record. Exits
non-zero, printing no result, without a CUDA device or without the
package beside it.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks the bounds use: 3.35 TB/s of HBM3 (NVIDIA data sheet)
# and 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 1.67e13 32-bit integer
# multiplies per second (Hopper architecture white paper's SM layout).
HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 132 * 64 * 1.98e9

GOLDEN_CODEWORD = {
    "GF32": "edf67c1247ff14ab94dd84ec24f200b7b40c9b65814b764ab29e7bc4494101e2",
    "GF16": "6a407726e3d6a7ee6501f145b3dcf4be91ecb2871357991b466357ee0f472fae",
}
GOLDEN_BLOB_GF32 = ("c480d93efb75815a9cbb06c65f014789"
                    "f4ea901e9929f50c11fc62cd542c7a9f")
GOLDEN_RAW_GF32 = ("97a84b82e7a7e222bceb2db7c583f934"
                   "df85cfc613fa36f06c360298177a9dc5")

REPLACES = {
    "K1_col": "fastecc_tpu/kernels/ntt_mfa.py:255",
    "K2_seam": "fastecc_tpu/kernels/ntt_mfa.py:549",
    "K3_row": "fastecc_tpu/kernels/ntt_mfa.py:302",
    "K4_col_pre": "fastecc_tpu/kernels/ntt_mfa.py:262",
    "K5_col_vec": "fastecc_tpu/kernels/ntt_mfa.py:274",
    "K6_seam_vec": "fastecc_tpu/kernels/ntt_mfa.py:563",
    "K7_row_post": "fastecc_tpu/kernels/ntt_mfa.py:308",
    "K7_row_post_sel": "fastecc_tpu/kernels/ntt_mfa.py:320",
    "K8_col_wire16": "fastecc_tpu/kernels/ntt_mfa.py:1099",
    "K9_seam_wire16": "fastecc_tpu/kernels/ntt_mfa.py:1123",
    "K10_row_wire16": "fastecc_tpu/kernels/ntt_mfa.py:1147",
    "K11_pair_lanes": "fastecc_tpu/kernels/ntt_mfa.py:902",
    "K12_pair_lanes_wire16": "fastecc_tpu/kernels/ntt_mfa.py:966",
    "K13_copy": "fastecc_tpu/kernels/microbench.py:37",
    "K14_chain": "fastecc_tpu/kernels/microbench.py:210",
    "K15_fused_chain": "fastecc_tpu/kernels/microbench.py:271",
}
WIRE16 = ("K8_col_wire16", "K9_seam_wire16", "K10_row_wire16")
LANES = ("K11_pair_lanes", "K12_pair_lanes_wire16")
PEAKS = ("K13_copy", "K14_chain", "K15_fused_chain")
SOURCE = {k: "fastecc_tpu_torch/csrc/" + (
    "microbench.cu" if k in PEAKS else "lanes.cu" if k in LANES
    else "row.cu" if k in ("K3_row", "K7_row_post", "K7_row_post_sel",
                           "K10_row_wire16")
    else "col.cu")
    for k in REPLACES}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(*parts) -> None:
    print(*parts, flush=True)


def rand_field(p: int, shape, gen: torch.Generator) -> torch.Tensor:
    from fastecc_tpu_torch import gf
    v = torch.randint(0, p, shape, dtype=torch.int64, device="cuda",
                      generator=gen)
    return gf.narrow(v)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    from fastecc_tpu_torch import gf
    return int((gf.widen(a) - gf.widen(b)).abs().max().item())


def compare(worst: dict, name: str, got: torch.Tensor, want: torch.Tensor,
            what) -> None:
    """Fail unless the kernel's ``got`` equals the plain ``want`` bit for
    bit; records the largest error under ``name``."""
    worst[name] = max(worst.get(name, 0), max_abs_err(got, want))
    check(torch.equal(got, want), f"{name} != plain at {what}")


def event_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs (CUDA events),
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def chunked_ms(fn, x: torch.Tensor, chunk: int, *more,
               outs: list | None = None) -> float:
    """Device time in ms of ``fn`` applied to every ``chunk``-lane slice
    of ``x`` (and of each tensor in ``more``, sliced alike; lanes are the
    last axis and independent): the plain versions at full width need
    more memory than the card has. ``outs``, if given, collects each
    slice's result in lane order."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for l0 in range(0, x.shape[-1], chunk):
        y = fn(*(t[..., l0:l0 + chunk].contiguous() for t in (x,) + more))
        if outs is not None:
            outs.append(y)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


# ---------------------------------------------------------------------------
# Work counts for the bounds.
# ---------------------------------------------------------------------------

def stage_mulmods(a: int) -> int:
    """Modular multiplies of one a-point transform column: a leading
    radix-2 stage (a/2) when log2 a is odd, then a per radix-4 stage."""
    t = a.bit_length() - 1
    return (a // 2 if t % 2 else 0) + a * (t // 2)


def pass_mulmods(kind: str, a: int, sel_frac: float = 1.0) -> float:
    """Per lane-column multiplies of a pass with transform length a
    (``sel_frac``: the share of rows K7-sel multiplies, e/n). The wire
    passes are K1, K2 and K3 on two halves (per-half lane columns)."""
    twin = dict(zip(WIRE16, ("K1_col", "K2_seam", "K3_row")))
    if kind in twin:
        return 2 * pass_mulmods(twin[kind], a)
    if kind == "K3_row":
        return stage_mulmods(a)
    if kind in ("K1_col", "K7_row_post"):
        return stage_mulmods(a) + a                   # + twiddle or table
    if kind == "K7_row_post_sel":
        return stage_mulmods(a) + a * sel_frac        # table at erased rows
    if kind in ("K4_col_pre", "K5_col_vec"):
        return stage_mulmods(a) + 2 * a               # + pre multiply, twiddle
    return 2 * stage_mulmods(a) + 2 * a               # seams K2, K6


def peaks_bound(kind: str, shape) -> tuple[float, str]:
    """(least time in ms, what bounds it) of a microbenchmark kernel at
    ``shape``. K13 copies n words: 8n bytes. K14 (solinas, [rows, 128] at
    depth d) reads x and z and writes y, 12 bytes per element, and does 2
    multiplies per step (the two words of a*b). K15 ([c, rows, 128] at
    depth d) reads and writes each word once and does a c-point
    transform's multiplies d times, 2 per GF32 mulmod."""
    if kind == "K13_copy":
        nbytes, muls = 8 * shape[0], 0
    elif kind == "K14_chain":
        rows, lanes, depth = shape
        nbytes, muls = 12 * rows * lanes, 2 * rows * lanes * depth
    else:
        c, rows, lanes, depth = shape
        nbytes = 8 * c * rows * lanes
        muls = 2 * stage_mulmods(c) * rows * lanes * depth
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT_MULS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(kind: str, field, shape, sel_frac: float = 1.0
          ) -> tuple[float, str]:
    """(least time in ms, what bounds it) for a pass over ``shape`` (for
    the wire passes, one half's [A, B, Wu]; for the lanes pair [k, L]).
    Bytes: the input read and the output written once, the [N] tables
    read once, and for K7-sel the original read at surviving rows only.
    The lanes pair runs two k-point transforms and the mid multiply on
    each lane column, K12 on both halves of each pair: pairs in, stored
    words and the bitmap out (8.5 bytes a pair)."""
    muls_per_mod = 2 if field.use_mont else 1
    if kind in LANES:
        k, lanes = shape
        halves = 2 if kind == "K12_pair_lanes_wire16" else 1
        nbytes = (8.5 if halves == 2 else 8) * k * lanes
        muls = halves * (2 * stage_mulmods(k) + k) * lanes * muls_per_mod
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = muls / INT_MULS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    a, b, lanes = shape
    words = a * b * lanes
    nbytes = 2 * 4 * words                            # read once, write once
    if kind in ("K5_col_vec", "K6_seam_vec", "K7_row_post"):
        nbytes += 4 * a * b                           # the [N] table
    if kind == "K7_row_post_sel":
        nbytes += 4 * words * (1 - sel_frac) + 8 * a * b   # orig; table, mask
    if kind == "K8_col_wire16":
        nbytes = 4 * words + 8 * words                # pairs in; lo, hi out
    if kind == "K9_seam_wire16":
        nbytes = 16 * words                           # lo, hi in and out
    if kind == "K10_row_wire16":
        nbytes = 8 * words + 4 * words + words // 2   # lo, hi in; stored, bitmap
    # GF32: the two words of a*b; for p = 0xFFF00001 the REDC's m and
    # (m*p) >> 32 are shift/add chains (fastecc_tpu_torch/gf.py mont_mul)
    muls = pass_mulmods(kind, a, sel_frac) * b * lanes * muls_per_mod
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT_MULS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from fastecc_tpu_torch.kernels import _build
    b = _build.build()
    _build.library()
    say(f"[build] {b.path.name} in {b.seconds:.1f} s")
    for line in b.log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("[nvcc]")):
            say("[build]", line.strip())


def phase_kernels(gen) -> dict:
    """Each kernel vs its plain version at the shapes the main-path runs
    below give it (on a 16-lane slice), and at small orders with a ragged
    lane count, in both fields; returns the worst error per kernel."""
    from fastecc_tpu_torch import gf
    from fastecc_tpu_torch.fields import GF16, GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m

    worst = {k: 0 for k in REPLACES if k not in PEAKS}
    escapes = {}

    def cmp(name, got, want, what):
        compare(worst, name, got, want, what)

    def pair(field, k, lanes):
        """The encode pair's passes at k: K1 (inverse), K2, K3."""
        g = field.root_of_order(2 * k)
        c1 = m._pair_split(k)
        r1 = k // c1
        x = rand_field(field.p, (c1, r1, lanes), gen)
        cmp("K1_col", m.col_pass(x, field, inverse=True),
            m.col_pass_plain(x, field, inverse=True), (field.name, k, "pair"))
        y1 = rand_field(field.p, (r1, c1, lanes), gen)
        cmp("K2_seam", m.seam_pass(y1, field, g),
            m.seam_pass_plain(y1, field, g), (field.name, k, "pair"))
        y2 = rand_field(field.p, (c1, r1, lanes), gen)
        cmp("K3_row", m.row_pass(y2, field), m.row_pass_plain(y2, field),
            (field.name, k, "pair"))

    def single(field, n, lanes, pre_seed=None):
        """A single transform's passes at n: K1 forward and inverse, K3,
        and K4 when ``pre_seed`` is given."""
        c = m._split(n)
        x = rand_field(field.p, (c, n // c, lanes), gen)
        for inv in (False, True):
            cmp("K1_col", m.col_pass(x, field, inverse=inv),
                m.col_pass_plain(x, field, inverse=inv), (field.name, n, inv))
        if pre_seed is not None:
            cmp("K4_col_pre", m.col_pass_pre(x, field, pre_seed),
                m.col_pass_plain(x, field, pre_seed=pre_seed),
                (field.name, n))
        y = rand_field(field.p, (n // c, c, lanes), gen)
        cmp("K3_row", m.row_pass(y, field), m.row_pass_plain(y, field),
            (field.name, n, "single"))

    def tables(field, n, g=gen):
        """A random prepared [n] table (GF16: with 0x10000 at every 7th
        row) and a mask with about half its rows set."""
        v = rand_field(field.p, (n,), g)
        if not field.use_mont:
            v.view(torch.int32)[::7] = 0x10000
        mask = torch.randint(0, 2, (n,), dtype=torch.int32, device="cuda",
                             generator=g).view(torch.uint32)
        return v, mask

    def decode_pair(field, n, lanes):
        """The decode pair's passes at n: K5 (inverse), K6, K7, K7-sel."""
        c1 = m._pair_split(n)
        r1 = n // c1
        v, mask = tables(field, n)
        x = rand_field(field.p, (c1, r1, lanes), gen)
        cmp("K5_col_vec", m.col_pass_vec(x, field, v, inverse=True),
            m.col_pass_plain(x, field, inverse=True, pre_vec=v),
            (field.name, n, "pair"))
        y1 = rand_field(field.p, (r1, c1, lanes), gen)
        cmp("K6_seam_vec", m.seam_pass_vec(y1, field, v),
            m.seam_pass_plain(y1, field, pre_vec2=v), (field.name, n))
        y2 = rand_field(field.p, (c1, r1, lanes), gen)
        orig = rand_field(field.p, (c1, r1, lanes), gen)
        cmp("K7_row_post", m.row_pass_post(y2, field, v),
            m.row_pass_plain(y2, field, post_vec=v), (field.name, n, "pair"))
        cmp("K7_row_post_sel", m.row_pass_post(y2, field, v, mask, orig),
            m.row_pass_plain(y2, field, post_vec=v, sel_mask=mask,
                             sel_orig=orig), (field.name, n, "pair"))

    def decode_single(field, n, lanes):
        """The all-device decode's single transforms at n: K5 forward and
        inverse, K7-sel."""
        c = m._split(n)
        v, mask = tables(field, n)
        x = rand_field(field.p, (c, n // c, lanes), gen)
        for inv in (False, True):
            cmp("K5_col_vec", m.col_pass_vec(x, field, v, inverse=inv),
                m.col_pass_plain(x, field, inverse=inv, pre_vec=v),
                (field.name, n, inv))
        y = rand_field(field.p, (n // c, c, lanes), gen)
        cmp("K7_row_post_sel", m.row_pass_post(y, field, v, mask, y),
            m.row_pass_plain(y, field, post_vec=v, sel_mask=mask, sel_orig=y),
            (field.name, n, "single"))

    def wire16(k, wu):
        """The wire pair's passes at k over wu lanes: K8, K9, K10."""
        g = GF16.root_of_order(2 * k)
        c1 = m._pair_split(k)
        r1 = k // c1
        x = torch.randint(-(1 << 31), 1 << 31, (c1, r1, wu),
                          dtype=torch.int32, device="cuda",
                          generator=gen).view(torch.uint32)
        cmp("K8_col_wire16", m.col_pass_wire16(x, GF16),
            m.col_pass_wire16_plain(x, GF16), ("wire16", k, wu))
        y = rand_field(GF16.p, (2, r1, c1, wu), gen)
        cmp("K9_seam_wire16", m.seam_pass_wire16(y, GF16, g),
            m.seam_pass_wire16_plain(y, GF16, g), ("wire16", k, wu))
        z = rand_field(GF16.p, (2, c1, r1, wu), gen)
        for got, want in zip(m.wire16_pass_b2(z[0], z[1], GF16),
                             m.row_pass_wire16_plain(z[0], z[1], GF16)):
            cmp("K10_row_wire16", got, want, ("wire16", k, wu))

    def dense_escapes(r2, c2, wu):
        """K10 on inputs whose transform output is ~90% 0x10000 in each
        half (tests/test_pallas.py's adversarial case): bitmap groups with
        many bits at once, saturated 0xFFFF words among them."""
        from fastecc_tpu_torch import interop, ntt
        rng = np.random.default_rng(7)
        k = r2 * c2

        def half():
            vals = rng.integers(0, 0x10000, (r2, c2, wu)).astype(np.uint32)
            want = np.where(rng.random((r2, c2, wu)) < 0.9,
                            np.uint32(0x10000), vals)
            pre = ntt.ntt_host(want.reshape(r2, c2 * wu), GF16, inverse=True)
            return want.reshape(k, wu), interop.from_numpy_u32(
                pre.reshape(r2, c2, wu))

        want_lo, lo = half()
        want_hi, hi = half()
        st = (want_lo & 0xFFFF) | ((want_hi & 0xFFFF) << np.uint32(16))
        sh = (2 * np.arange(8)).astype(np.uint32)
        bm = (((want_lo >> 16).reshape(k, wu // 8, 8) << sh)
              | ((want_hi >> 16).reshape(k, wu // 8, 8) << (sh + 1))).sum(
                  axis=-1).astype(np.uint32)
        check((bm == 0xFFFF).any(), "dense case has saturated words")
        got = m.wire16_pass_b2(lo, hi, GF16)
        for g_, plain, w in zip(got, m.row_pass_wire16_plain(lo, hi, GF16),
                                (st, bm)):
            cmp("K10_row_wire16", g_, plain, ("dense escapes", r2, c2, wu))
            cmp("K10_row_wire16", g_, interop.from_numpy_u32(w),
                ("dense escapes, expected", r2, c2, wu))

    def lanes(field, k, lanes_):
        """K11 over [k, lanes_]."""
        g = field.root_of_order(2 * k)
        x = rand_field(field.p, (k, lanes_), gen)
        cmp("K11_pair_lanes", m.ntt_pair_lanes(x, field, g),
            m.pair_lanes_plain(x, field, g), (field.name, k, lanes_))

    def lanes_wire16(k, wu, dense=False):
        """K12 over [k, wu] random u32 pairs or, with ``dense``, pairs whose
        outputs are ~90% 0x10000; records the escape bits it wrote."""
        g = GF16.root_of_order(2 * k)
        x = (dense_escape_pairs(k, wu, g, gen) if dense else torch.randint(
            -(1 << 31), 1 << 31, (k, wu), dtype=torch.int32, device="cuda",
            generator=gen).view(torch.uint32))
        got = m.ntt_pair_lanes_wire16(x, GF16, g)
        for a, b in zip(got, m.pair_lanes_wire16_plain(x, GF16, g)):
            cmp("K12_pair_lanes_wire16", a, b, ("lanes wire16", k, wu, dense))
        bits = gf.widen(got[1])
        escapes[(k, wu, dense)] = (
            int(sum(((bits >> b) & 1).sum().item() for b in range(16))),
            int((bits == 0xFFFF).sum().item()))

    # main-path shapes: encode_r2 (k = 2^19), encode_r4 (k = 2^18, the
    # coset NTTs' K4), ntt (2^20), wire (k = 2^14); the decode pair at
    # 2^20 (decode) and 2^13 (decode_blocks), the single-transform decode
    # at 2^13 (decode_small); GF16 at its largest
    decode_pair(GF32, 1 << 20, 16)
    decode_pair(GF32, 1 << 13, 16)
    decode_single(GF32, 1 << 13, 16)
    decode_pair(GF16, 1 << 16, 16)
    say("[kernels] decode shapes, 16 lanes, GF32 and GF16: K5-K7 == plain")
    pair(GF32, 1 << 19, 16)
    single(GF32, 1 << 18, 16, GF32.root_of_order(1 << 20))
    single(GF32, 1 << 20, 16)
    pair(GF32, 1 << 14, 16)
    pair(GF16, 1 << 15, 16)
    single(GF16, 1 << 15, 16, GF16.root_of_order(1 << 16))
    say("[kernels] main-path shapes, 16 lanes, GF32 and GF16: "
        "K1-K4 == plain")
    for field in (GF32, GF16):
        for k in (4, 8, 1 << 7):
            pair(field, k, 13)
            single(field, k, 13, field.root_of_order(4 * k))
            decode_pair(field, k, 13)
            decode_single(field, k, 13)
    say("[kernels] orders 4, 8, 128, 13 lanes, GF32 and GF16: "
        "K1-K7 == plain")
    # K3 and K7-sel have one instantiation per length and direction:
    # every A, both directions, on 13 lanes (the 4-byte copies), 40 and,
    # at A >= 512, 1088 (the last lane tile); K7-sel with its original a
    # tensor of its own and the pass's input. K6's and K7-sel's operands
    # come from a generator of their own: the other checks' data stays.
    gen8 = torch.Generator(device="cuda").manual_seed(8)
    for field in (GF32, GF16):
        for la in range(1, 11):
            a = 1 << la
            for lanes_ in (13, 40) + ((1088,) if a >= 512 else ()):
                y = rand_field(field.p, (a, 3 if lanes_ < 1088 else 2,
                                         lanes_), gen)
                v, mask = tables(field, a * y.shape[1], gen8)
                orig = rand_field(field.p, tuple(y.shape), gen8)
                for inv in (False, True):
                    cmp("K3_row", m.row_pass(y, field, inv),
                        m.row_pass_plain(y, field, inv),
                        (field.name, a, lanes_, inv))
                    cmp("K7_row_post", m.row_pass_post(y, field, v,
                                                       inverse=inv),
                        m.row_pass_plain(y, field, inv, v),
                        (field.name, a, lanes_, inv))
                    for o in (orig, y):
                        cmp("K7_row_post_sel",
                            m.row_pass_post(y, field, v, mask, o, inv),
                            m.row_pass_plain(y, field, inv, v, mask, o),
                            (field.name, a, lanes_, inv, o is y))
    # K7 on a view 4 bytes past a 16-byte boundary (the 4-byte copies),
    # from a generator of its own
    gen7 = torch.Generator(device="cuda").manual_seed(7)
    for field in (GF32, GF16):
        for la in range(1, 11):
            a = 1 << la
            v, _ = tables(field, a * 3, gen7)
            y = rand_field(field.p, (a * 3 * 8 + 1,), gen7)[1:].view(a, 3, 8)
            check(y.data_ptr() % 16 == 4, "K7's view is 4 bytes past 16")
            for inv in (False, True):
                cmp("K7_row_post", m.row_pass_post(y, field, v, inverse=inv),
                    m.row_pass_plain(y, field, inv, v),
                    (field.name, a, "offset view", inv))
    say("[kernels] K3, K7 and K7-sel (its original apart and the input) at "
        "A = 2 .. 1024, forward and inverse, 13 and 40 lanes (1088 at A >= "
        "512), K7 also on a view 4 bytes past a 16-byte boundary, GF32 and "
        "GF16: == plain")
    # K1, K2 and K6 likewise (one instantiation per length, K1 per
    # direction): [A, 4, L], two seed columns and two t0 rows; K4 and K5
    # on the same tensors, their tables from a generator of their own (K4
    # at g of order 4A, so that GF16's pcol and prow hold 0x10000)
    gen9 = torch.Generator(device="cuda").manual_seed(9)
    for field in (GF32, GF16):
        for la in range(1, 11):
            a = 1 << la
            g = field.root_of_order(8 * a)
            g4 = field.root_of_order(4 * a)
            for lanes_ in (13, 40) + ((1088,) if a >= 512 else ()):
                x = rand_field(field.p, (a, 4, lanes_), gen)
                v5, _ = tables(field, a * 4, gen9)
                for inv, scale in ((False, True), (True, True), (True, False)):
                    what = (field.name, a, lanes_, inv, scale)
                    cmp("K1_col", m.col_pass(x, field, inv, scale),
                        m.col_pass_plain(x, field, inv, scale), what)
                    cmp("K4_col_pre", m.col_pass_pre(x, field, g4, inv, scale),
                        m.col_pass_plain(x, field, inv, scale, pre_seed=g4),
                        what)
                    cmp("K5_col_vec", m.col_pass_vec(x, field, v5, inv, scale),
                        m.col_pass_plain(x, field, inv, scale, pre_vec=v5),
                        what)
                cmp("K2_seam", m.seam_pass(x, field, g),
                    m.seam_pass_plain(x, field, g), (field.name, a, lanes_))
                v, _ = tables(field, a * 4, gen8)
                cmp("K6_seam_vec", m.seam_pass_vec(x, field, v),
                    m.seam_pass_plain(x, field, pre_vec2=v),
                    (field.name, a, lanes_))
    say("[kernels] K1, K4 and K5 (forward, inverse scaled and not), K2 and "
        "K6 at A = 2 .. 1024 on [A, 4, L], 13 and 40 lanes (1088 at A >= "
        "512), GF32 and GF16: == plain")
    # the wire16 phase's k = 2^13 (both block sizes), GF16's largest pair,
    # and small orders with Wu a multiple of 8 but not of the lane tile
    for k, wu in ((1 << 13, 16), (1 << 15, 16), (4, 8), (1 << 7, 40)):
        wire16(k, wu)
    dense_escapes(16, 16, 256)
    say("[kernels] wire16 at k = 2^13, 2^15 (16 lanes), 4 (8), 2^7 (40) "
        "and dense escapes: K8-K10 == plain")
    # the lanes pair at the gate's ends and the batch's k = 2^10; lane
    # tiles of 32, 16 and 4 (K11 in GF32 at 2^13: 2)
    for field in (GF32, GF16):
        for k in (32, 1 << 10, 1 << 13):
            for lanes_ in (1088, 13):
                lanes(field, k, lanes_)
    say("[kernels] K11 at k = 32, 2^10, 2^13 over 1088 and 13 lanes, GF32 "
        "and GF16: == plain")
    for k in (32, 1 << 10, 1 << 13):
        for wu in (8, 40, 1024):
            lanes_wire16(k, wu)
        lanes_wire16(k, 40 if k < 1 << 13 else 1024, dense=True)
    check(escapes[(1 << 13, 1024, False)][0] > 0,
          "no escapes in K12's parity at k = 2^13, Wu = 1024")
    check(all(v[1] > 0 for (_, _, d), v in escapes.items() if d),
          "dense K12 cases have saturated bitmap words")
    say("[kernels] K12 at k = 32, 2^10, 2^13 over Wu = 8, 40, 1024 and "
        "dense escapes: == plain; escape bits (saturated words): " +
        ", ".join(f"k={k} Wu={wu}{' dense' if d else ''}: {b} ({sat})"
                  for (k, wu, d), (b, sat) in escapes.items()))
    # K12 has one instantiation per length (the engine's one-exchange split
    # below 2^12, the two-exchange split at 2^12 and 2^13): every k = 4 ..
    # 2^13 over Wu = 8, 40 and 1024 (lane tiles of 32 down to 4, ragged),
    # from a generator of its own
    gen12 = torch.Generator(device="cuda").manual_seed(12)
    for la in range(2, 14):
        k = 1 << la
        g = GF16.root_of_order(2 * k)
        for wu in (8, 40, 1024):
            x = torch.randint(-(1 << 31), 1 << 31, (k, wu), dtype=torch.int32,
                              device="cuda", generator=gen12).view(
                                  torch.uint32)
            for a, b in zip(m.ntt_pair_lanes_wire16(x, GF16, g),
                            m.pair_lanes_wire16_plain(x, GF16, g)):
                cmp("K12_pair_lanes_wire16", a, b, ("every k", k, wu))
    say("[kernels] K12 at every k = 4 .. 2^13 over Wu = 8, 40, 1024: == "
        "plain")
    # K9 is K2's kernel on each half: every R1 = 2 .. 1024 on [2, R1, 4,
    # Wu], Wu = 8, 16, 40, GF16 (the pair split reaches R1 = 256 at 2^15;
    # 512 and 1024 only through seam_pass_wire16 itself)
    gen11 = torch.Generator(device="cuda").manual_seed(11)
    for la in range(1, 11):
        a = 1 << la
        g = GF16.root_of_order(8 * a)
        for wu in (8, 16, 40):
            y = rand_field(GF16.p, (2, a, 4, wu), gen11)
            cmp("K9_seam_wire16", m.seam_pass_wire16(y, GF16, g),
                m.seam_pass_wire16_plain(y, GF16, g), ("every R1", a, wu))
    say("[kernels] K9 at every R1 = 2 .. 1024 on [2, R1, 4, Wu], Wu = 8, "
        "16, 40: == plain")
    # K8 is K1's GF16 kernel on both halves of the pairs, one
    # instantiation per length: every C1 = 2 .. 1024 on [C1, 4, Wu] random
    # 32-bit pairs, Wu = 8, 40, 1024, and on a view 4 bytes past a 16-byte
    # boundary (the 4-byte copies)
    gen10 = torch.Generator(device="cuda").manual_seed(10)

    def words(*shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                             device="cuda", generator=gen10).view(
                                 torch.uint32)
    for la in range(1, 11):
        a = 1 << la
        views = [words(a, 4, wu) for wu in (8, 40, 1024)]
        views.append(words(a * 4 * 8 + 1)[1:].view(a, 4, 8))
        check(views[-1].data_ptr() % 16 == 4, "K8's view is 4 bytes past 16")
        for x in views:
            cmp("K8_col_wire16", m.col_pass_wire16(x, GF16),
                m.col_pass_wire16_plain(x, GF16),
                ("every C1", a, x.shape[-1], x.data_ptr() % 16))
    say("[kernels] K8 at every C1 = 2 .. 1024 on [C1, 4, Wu] random 32-bit "
        "pairs, Wu = 8, 40, 1024 and a view 4 bytes past a 16-byte "
        "boundary: == plain")
    # K10 has one instantiation per length (GF16 forward; TL = 32 up to
    # A = 512, 16 at 1024): every A = 2 .. 1024 on [A, 2, Wu] over Wu = 8,
    # 40 and 1032
    # (the last lane tile holds 8 lanes), and on lo and hi views 4 bytes
    # past a 16-byte boundary (the 4-byte copies), 0x10000 at about a
    # tenth of the elements; from a generator of its own
    gen13 = torch.Generator(device="cuda").manual_seed(13)

    def halves(*shape):
        v = gf.widen(rand_field(GF16.p, shape, gen13))
        esc = torch.rand(shape, device="cuda", generator=gen13) < 0.1
        return gf.narrow(torch.where(esc, 0x10000, v))
    for la in range(1, 11):
        a = 1 << la
        cases = [halves(2, a, 2, wu) for wu in (8, 40, 1032)]
        flat = halves(2 * a * 2 * 8 + 1)[1:]
        cases.append(flat.view(2, a, 2, 8))
        check(cases[-1][0].data_ptr() % 16 == 4
              and cases[-1][1].data_ptr() % 16 == 4,
              "K10's views are 4 bytes past 16")
        for h in cases:
            for got, want in zip(m.wire16_pass_b2(h[0], h[1], GF16),
                                 m.row_pass_wire16_plain(h[0], h[1], GF16)):
                cmp("K10_row_wire16", got, want,
                    ("every A", a, h.shape[-1], h[0].data_ptr() % 16))
    dense_escapes(1024, 2, 64)
    say("[kernels] K10 at every A = 2 .. 1024 on [A, 2, Wu], Wu = 8, 40, "
        "1032 and views 4 bytes past a 16-byte boundary, and dense escapes "
        "at A = 1024: == plain and the expected words")
    # K11 has one instantiation per length and field (the one-exchange
    # split below 2^11, the two-exchange split from 2^11 on): every
    # k = 4 .. 2^13 over 13 and 1088 lanes and on a view 4 bytes past a
    # 16-byte boundary, both fields, from a generator of its own
    gen14 = torch.Generator(device="cuda").manual_seed(14)
    for field in (GF32, GF16):
        for la in range(2, 14):
            k = 1 << la
            g = field.root_of_order(2 * k)
            xs = [rand_field(field.p, (k, n), gen14) for n in (13, 1088)]
            xs.append(rand_field(field.p, (k * 8 + 1,), gen14)[1:].view(k, 8))
            check(xs[-1].data_ptr() % 16 == 4, "K11's view is 4 bytes past 16")
            for x in xs:
                cmp("K11_pair_lanes", m.ntt_pair_lanes(x, field, g),
                    m.pair_lanes_plain(x, field, g),
                    ("every k", field.name, k, x.shape[1],
                     x.data_ptr() % 16))
    say("[kernels] K11 at every k = 4 .. 2^13 over 13 and 1088 lanes and a "
        "view 4 bytes past a 16-byte boundary, GF32 and GF16: == plain")
    return worst


def dense_escape_pairs(k: int, wu: int, g: int, gen) -> torch.Tensor:
    """[k, wu] u32 pairs whose wire pair output (seed g) is ~90% 0x10000
    in each half: the pair with seed g^-1, the pair's inverse, applied to
    such outputs. Preimage values of 0x10000, which a u16 word cannot
    hold, become 0 (that lane column loses its density)."""
    from fastecc_tpu_torch import gf
    from fastecc_tpu_torch.fields import GF16
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    halves = []
    for _ in range(2):
        vals = gf.widen(rand_field(GF16.p, (k, wu), gen))
        dense = torch.rand((k, wu), device="cuda", generator=gen) < 0.9
        want = gf.narrow(torch.where(dense, 0x10000, vals))
        pre = gf.widen(m.pair_lanes_plain(want, GF16, GF16.inv_host(g)))
        halves.append(torch.where(pre == 0x10000, 0, pre))
    return gf.narrow(halves[0] | (halves[1] << 16))


def _blocks_gf32() -> np.ndarray:
    """tests/test_wire_golden.py's [4, 4096] GF32 fixture."""
    rng = np.random.default_rng(0xC13)
    w = rng.integers(0, 1 << 32, size=(4, 1024),
                     dtype=np.uint64).astype(np.uint32)
    p = 0xFFF00001
    w[0, :8] = [0, 1, p - 1, p, p + 1, 0xFFFFFFFF, 0xFFF00000, 0xFFFFFFFE]
    raw = np.frombuffer(w.astype("<u4").tobytes(),
                        np.uint8).reshape(4, 4096).copy()
    check(hashlib.sha256(raw.tobytes()).hexdigest() == GOLDEN_RAW_GF32,
          "wire fixture generator drifted")
    return raw


def phase_golden() -> None:
    from fastecc_tpu_torch import interop, rs
    from fastecc_tpu_torch.fields import GF16, GF32
    for field in (GF32, GF16):
        k, lanes = 64, 4
        i = np.arange(k, dtype=np.uint64)[:, None]
        l = np.arange(lanes, dtype=np.uint64)[None, :]
        data = ((i * 1000003 + l * 7919 + 1) % field.p).astype(np.uint32)
        cw = rs.encode(data, field, 2 * k)                # numpy -> card
        check(cw.is_cuda, "encode did not run on the card")
        digest = hashlib.sha256(interop.to_numpy_u32(cw).tobytes()).hexdigest()
        check(digest == GOLDEN_CODEWORD[field.name],
              f"{field.name} codeword digest {digest}")
        say(f"[golden] {field.name} codeword sha256 {digest[:16]}... ok")
    blob = rs.encode_blocks(_blocks_gf32(), GF32, 8)
    check(blob.is_cuda and tuple(blob.shape) == (4, 4352), "blob shape")
    digest = hashlib.sha256(blob.cpu().numpy().tobytes()).hexdigest()
    check(digest == GOLDEN_BLOB_GF32, f"GF32 encode_blocks digest {digest}")
    say(f"[golden] GF32 encode_blocks sha256 {digest[:16]}... ok")


def staged_encode_ref(x, field, n):
    """Plain staged reference for encode_parity on a few lanes: iNTT, then
    one coset NTT per parity coset (the reference's generic path)."""
    from fastecc_tpu_torch import gf, ntt
    k = x.shape[0]
    w_n = field.root_of_order(n)
    coeffs = ntt.intt(x, field)
    out = []
    for r in range(1, n // k):
        pre = gf.table(ntt._pre_powers(field.name, field.pow_host(w_n, r),
                                       k), x.device)[:, None]
        out.append(gf.widen(ntt.ntt(ntt.mul_prepared(field, coeffs, pre),
                                    field, radix=4)))
    return gf.narrow(torch.stack(out, dim=1).reshape(n - k, x.shape[1]))


def profile_once(fn, name: str, warmup: bool = True) -> float:
    """One call under torch.profiler (after one untimed call unless
    ``warmup`` is False): device time per kernel name (the six largest,
    then the port's own kernels among the rest) and the device's busy
    share of the call's wall time, which it returns."""
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the tracer can miss the window's first kernel: let a tiny fill
        # take that place, outside the timed call
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, evt.count, evt.key[:60]))
    busy = sum(r[0] for r in rows)
    say(f"[{name}] profiler: device busy {busy / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms wall ({100 * busy / wall_us:.1f}%)")
    rows.sort(reverse=True)
    port = [r for r in rows[6:] if "(anonymous namespace)::" in r[2]]
    for dev_us, count, key in rows[:6] + port:
        say(f"[{name}] profiler: {dev_us / 1e3:8.3f} ms x{count} {key}")
    return busy / wall_us


def uint32_arithmetic() -> str:
    """Whether this PyTorch build adds uint32 tensors on the card (the
    port widens to int64 carriers either way)."""
    a = torch.ones(4, dtype=torch.uint32, device="cuda")
    try:
        return f"supported ({int((a + a)[0].item())})"
    except (RuntimeError, NotImplementedError) as e:
        return f"unsupported ({str(e).splitlines()[0][:60]})"


def run_path(name: str, fn, launches: dict, expect: tuple):
    """Run ``fn`` once with the counts reset just before and read just
    after; records them under ``name`` and fails unless every kernel in
    ``expect`` launched."""
    from fastecc_tpu_torch.kernels import microbench, ntt_mfa
    torch.cuda.synchronize()
    ntt_mfa.reset_launches()
    microbench.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches[name] = {**ntt_mfa.LAUNCHES, **microbench.LAUNCHES}
    say(f"[{name}] launches {launches[name]}")
    for k in expect:
        check(launches[name][k] > 0, f"{name} did not launch {k}")
    return out


def check_edge_lanes(name: str, got: torch.Tensor, ref_fn,
                     x: torch.Tensor) -> None:
    """``got``'s first and last 8 lanes == ``ref_fn`` (a plain staged
    reference) on those lanes of ``x`` alone: lanes are independent, and
    the two slices fall in the first and the last lane tile of every
    pass."""
    lanes = x.shape[-1]
    for l0 in (0, lanes - 8):
        ref = ref_fn(x[:, l0:l0 + 8].contiguous())
        check(torch.equal(got[:, l0:l0 + 8], ref),
              f"{name} lanes {l0}-{l0 + 7} != plain staged")
    say(f"[{name}] lanes 0-7 and {lanes - 8}-{lanes - 1} == plain staged "
        f"transforms")


def gf_sum(t: torch.Tensor) -> int:
    from fastecc_tpu_torch import gf
    return int(gf.widen(t).sum().item())


def all_below_p(t: torch.Tensor, p: int) -> bool:
    from fastecc_tpu_torch import gf
    return int(gf.widen(t).max().item()) < p


def phase_encode(gen, launches, times, shapes):
    from fastecc_tpu_torch import rs
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    from fastecc_tpu_torch.utils.timer import median, time_samples

    k, lanes = 1 << 19, 1024
    n = 2 * k
    data = rand_field(GF32.p, (k, lanes), gen)
    par = run_path("encode_r2", lambda: rs.encode_parity(data, GF32, n),
                   launches, ("K1_col", "K2_seam", "K3_row"))
    check(tuple(par.shape) == (k, lanes), "encode parity shape")
    check(all_below_p(par, GF32.p), "parity values < p")
    check_edge_lanes("encode_r2", par,
                     lambda x: staged_encode_ref(x, GF32, n), data)
    del par
    samples = time_samples(lambda: rs.encode_parity(data, GF32, n),
                           iters=5, warmup=1)
    t = median(samples)
    times["encode_s"] = t
    times["encode_gbps"] = n * lanes * 4 / t / 1e9
    say(f"[encode_r2] median {t * 1e3:.3f} ms of {[round(s * 1e3, 3) for s in samples]}"
        f" -> {times['encode_gbps']:.2f} GB/s codeword")
    profile_once(lambda: rs.encode_parity(data, GF32, n), "encode_r2")

    # per-kernel device times at the main-path shapes
    g = GF32.root_of_order(n)
    c1 = m._pair_split(k)
    x3 = data.reshape(c1, k // c1, lanes)
    col1 = m.col_pass(x3, GF32, inverse=True)
    col2 = m.seam_pass(col1, GF32, g)
    times["K1_col"] = event_ms(lambda: m.col_pass(x3, GF32, inverse=True))
    times["K2_seam"] = event_ms(lambda: m.seam_pass(col1, GF32, g))
    times["K3_row"] = event_ms(lambda: m.row_pass(col2, GF32))
    shapes["K1_col"] = tuple(x3.shape)
    shapes["K2_seam"] = tuple(col1.shape)
    shapes["K3_row"] = tuple(col2.shape)
    times["plain_K1_col"] = chunked_ms(
        lambda x: m.col_pass_plain(x, GF32, inverse=True), x3, 128)
    times["plain_K2_seam"] = chunked_ms(
        lambda x: m.seam_pass_plain(x, GF32, g), col1, 128)
    times["plain_K3_row"] = chunked_ms(
        lambda x: m.row_pass_plain(x, GF32), col2, 128)
    for kk in ("K1_col", "K2_seam", "K3_row"):
        say(f"[encode_r2] {kk} {times[kk]:.3f} ms on {shapes[kk]}, "
            f"plain {times['plain_' + kk]:.1f} ms")
    parent_row_ms(col2)
    parent_col_ms(x3, True, "encode_r2")
    parent_seam_ms(col1, g)
    parent_col_tables_ms()
    del data, x3, col1, col2
    torch.cuda.empty_cache()

    # rate 1/4: iNTT (K1 -> K3) and three coset NTTs (K4 -> K3)
    k4 = 1 << 18
    n4 = 4 * k4
    data = rand_field(GF32.p, (k4, lanes), gen)
    par = run_path("encode_r4", lambda: rs.encode_parity(data, GF32, n4),
                   launches, ("K1_col", "K3_row", "K4_col_pre"))
    check(tuple(par.shape) == (3 * k4, lanes), "rate-1/4 parity shape")
    check_edge_lanes("encode_r4", par,
                     lambda x: staged_encode_ref(x, GF32, n4), data)
    del par
    profile_once(lambda: rs.encode_parity(data, GF32, n4), "encode_r4")
    g4 = GF32.root_of_order(n4)
    c = m._split(k4)
    x4 = data.reshape(c, k4 // c, lanes)
    times["K4_col_pre"] = event_ms(lambda: m.col_pass_pre(x4, GF32, g4))
    shapes["K4_col_pre"] = tuple(x4.shape)
    times["plain_K4_col_pre"] = chunked_ms(
        lambda x: m.col_pass_plain(x, GF32, pre_seed=g4), x4, 128)
    say(f"[encode_r4] K4_col_pre {times['K4_col_pre']:.3f} ms on "
        f"{shapes['K4_col_pre']}, plain {times['plain_K4_col_pre']:.1f} ms")
    parent_col_pre_ms(x4, g4)
    del data, x4
    torch.cuda.empty_cache()


@functools.lru_cache(maxsize=None)
def parent_library():
    """The kernel library of the earlier checkout of the package in
    build/parent (as ``sass_check.py --compare build/parent`` wants it),
    built there by its own ``_build``; None where there is none. The
    argtypes are the parent commit's C signatures (K1-K10, K7-sel and K15
    with the inner twiddles, K11 and K12 with the level and inner tables
    of ``_lanes_tables_on``)."""
    import ctypes
    from pathlib import Path
    root = Path(__file__).resolve().parent / "build" / "parent"
    if not (root / "fastecc_tpu_torch" / "kernels" / "_build.py").exists():
        return None
    code = ("from fastecc_tpu_torch.kernels import _build; "
            "print(_build.build().path)")
    t0 = time.perf_counter()
    lib = ctypes.CDLL(subprocess.run(
        [sys.executable, "-c", code], cwd=root, check=True,
        capture_output=True, text=True).stdout.strip().splitlines()[-1])
    say(f"[parent] kernel library of build/parent built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fecc_row.argtypes = [I, P, P, I, I, I, I, P, P]
    lib.fecc_col.argtypes = [I, P, P, I, I, I, I, P, P, P, I, P]
    lib.fecc_seam.argtypes = [I, P, P, I, I, I, P, P, P, P, I, P, P, P]
    lib.fecc_seam_vec.argtypes = [I, P, P, I, I, I, P, P, P, P, I, P, P]
    lib.fecc_row_post_sel.argtypes = [I, P, P, I, I, I, I, P, P, P, P, P]
    lib.fecc_col_pre.argtypes = [I, P, P, I, I, I, I, P, P, P, I, P, P, P]
    lib.fecc_col_vec.argtypes = [I, P, P, I, I, I, I, P, P, P, I, P, P]
    lib.fecc_copy.argtypes = [P, P, ctypes.c_longlong, P]
    lib.fecc_chain.argtypes = [I, P, P, P, I, I, P]
    lib.fecc_fused_chain.argtypes = [I, P, P, I, I, P, I, P]
    lib.fecc_seam_wire16.argtypes = [I, P, P, I, I, I, P, P, P, P, I, P, P,
                                     P]
    lib.fecc_pair_lanes_wire16.argtypes = [I, P, P, P, I, I, P, P, P, P, P,
                                           P]
    lib.fecc_row_post.argtypes = [I, P, P, I, I, I, I, P, P, P]
    lib.fecc_col_wire16.argtypes = [I, P, P, I, I, I, P, P, P, I, P]
    # K10 (the forward inner twiddles) and K11 (lvl_i, lvl_f, tw_i, tw_f,
    # mid)
    lib.fecc_row_wire16.argtypes = [I, P, P, P, P, I, I, I, P, P]
    lib.fecc_pair_lanes.argtypes = [I, P, P, I, I, P, P, P, P, P, P]
    for fn in (lib.fecc_row, lib.fecc_col, lib.fecc_seam, lib.fecc_seam_vec,
               lib.fecc_row_post_sel, lib.fecc_col_pre, lib.fecc_col_vec,
               lib.fecc_copy, lib.fecc_chain, lib.fecc_fused_chain,
               lib.fecc_seam_wire16, lib.fecc_pair_lanes_wire16,
               lib.fecc_row_post, lib.fecc_col_wire16, lib.fecc_row_wire16,
               lib.fecc_pair_lanes):
        fn.restype = I
    return lib


def queued_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs, queued behind
    a spin kernel of a few ms so that the card runs them back to back: for
    kernels shorter than their host launch cost, which ``event_ms`` would
    time instead."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def turns(parent, this, timer, what: str) -> list[float]:
    """The parent's kernel against this tree's: ``parent()`` and
    ``this()`` return their outputs, held equal, then each is timed by
    ``timer`` in turns parent, this, this, parent."""
    check(torch.equal(parent(), this()), f"parent {what} != this {what}")
    return [timer(f) for f in (parent, this, this, parent)]


def parent_call(name: str, x: torch.Tensor, out: torch.Tensor, *args):
    """A call of the parent library's C entry ``name`` on GF32 ``x`` into
    ``out`` with ``args`` after (A, B, L), on the current stream."""
    lib = parent_library()
    a, b, lanes = x.shape

    def call():
        code = getattr(lib, name)(0, x.data_ptr(), out.data_ptr(), a, b,
                                  lanes, *args,
                                  torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"parent {name} returned {code}")
        return out
    return call


def parent_row(y: torch.Tensor):
    """The parent's K3 (``fecc_row``, forward, with the inner twiddles)."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    tw = m._row_tw_on(GF32.name, y.shape[0], False, str(y.device))
    return parent_call("fecc_row", y, torch.empty_like(y), 0, tw.data_ptr())


def parent_col(x3: torch.Tensor, inverse: bool, scale: bool = True):
    """The parent's K1 (``fecc_col`` with the inner twiddles) on
    [C, R, L]."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    c, r, lanes = x3.shape
    dev = str(x3.device)
    tr = m._seed_tr(r)
    tw = m._row_tw_on(GF32.name, c, inverse, dev)
    seed, t0 = m._seeds_on(GF32.name, c * r, c, inverse, scale, tr, dev)
    out = torch.empty((r, c, lanes), dtype=torch.uint32, device=x3.device)
    return parent_call("fecc_col", x3, out, int(inverse), tw.data_ptr(),
                       seed.data_ptr(), t0.data_ptr(), tr)


def parent_seam_tables(y1: torch.Tensor):
    """(out, tr, seed, t0) of a seam over [R1, C1, L]."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    r1, c1, lanes = y1.shape
    tr = m._seed_tr(c1)
    seed, t0 = m._seeds_on(GF32.name, r1 * c1, r1, False, False, tr,
                           str(y1.device))
    out = torch.empty((c1, r1, lanes), dtype=torch.uint32, device=y1.device)
    return out, tr, seed, t0


def parent_seam(y1: torch.Tensor, g: int):
    """The parent's K2 (``fecc_seam`` with the inner twiddles) on
    [R1, C1, L]."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    r1, c1, _ = y1.shape
    dev = str(y1.device)
    out, tr, seed, t0 = parent_seam_tables(y1)
    tw_inv = m._row_tw_on(GF32.name, r1, True, dev)
    tw_fwd = m._row_tw_on(GF32.name, r1, False, dev)
    pcol, prow = m._pre_on(GF32.name, g % GF32.p, r1, c1, tr, dev)
    return parent_call("fecc_seam", y1, out, tw_inv.data_ptr(),
                       tw_fwd.data_ptr(), seed.data_ptr(), t0.data_ptr(), tr,
                       pcol.data_ptr(), prow.data_ptr())


def parent_seam_vec(y1: torch.Tensor, vec: torch.Tensor):
    """The parent's K6 (``fecc_seam_vec`` with the inner twiddles) on
    [R1, C1, L]."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    r1 = y1.shape[0]
    dev = str(y1.device)
    out, tr, seed, t0 = parent_seam_tables(y1)
    tw_inv = m._row_tw_on(GF32.name, r1, True, dev)
    tw_fwd = m._row_tw_on(GF32.name, r1, False, dev)
    return parent_call("fecc_seam_vec", y1, out, tw_inv.data_ptr(),
                       tw_fwd.data_ptr(), seed.data_ptr(), t0.data_ptr(), tr,
                       vec.data_ptr())


def parent_row_post_sel(y: torch.Tensor, vec: torch.Tensor,
                        mask: torch.Tensor, orig: torch.Tensor):
    """The parent's K7-sel (``fecc_row_post_sel`` with the inner
    twiddles, forward) on [R, C, L]."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    tw = m._row_tw_on(GF32.name, y.shape[0], False, str(y.device))
    return parent_call("fecc_row_post_sel", y, torch.empty_like(y), 0,
                       tw.data_ptr(), vec.data_ptr(), mask.data_ptr(),
                       orig.data_ptr())


def parent_row_post(y: torch.Tensor, vec: torch.Tensor):
    """The parent's K7 (``fecc_row_post`` with the inner twiddles,
    forward) on [R, C, L]."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    tw = m._row_tw_on(GF32.name, y.shape[0], False, str(y.device))
    return parent_call("fecc_row_post", y, torch.empty_like(y), 0,
                       tw.data_ptr(), vec.data_ptr())


def parent_col_pre_vec(x3: torch.Tensor, inverse: bool, scale: bool = True,
                       g: int | None = None, vec: torch.Tensor | None = None):
    """The parent's K4 (``fecc_col_pre``, with ``g``) or K5
    (``fecc_col_vec``, with ``vec``), with the inner twiddles, on
    [C, R, L]."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    c, r, lanes = x3.shape
    dev = str(x3.device)
    tr = m._seed_tr(r)
    tw = m._row_tw_on(GF32.name, c, inverse, dev)
    seed, t0 = m._seeds_on(GF32.name, c * r, c, inverse, scale, tr, dev)
    out = torch.empty((r, c, lanes), dtype=torch.uint32, device=x3.device)
    args = [int(inverse), tw.data_ptr(), seed.data_ptr(), t0.data_ptr(), tr]
    if vec is not None:
        return parent_call("fecc_col_vec", x3, out, *args, vec.data_ptr())
    pcol, prow = m._pre_on(GF32.name, g % GF32.p, c, r, tr, dev)
    return parent_call("fecc_col_pre", x3, out, *args, pcol.data_ptr(),
                       prow.data_ptr())


def table_shapes(split) -> list[tuple]:
    """The [A, B, L] views the decode tables give a pass at e = 2^19: the
    product tree's 2^19-element transforms of 2^2 .. 2^19 points (``split``
    of the order: (A, B)), the [2^20, 2] evaluation, decode_small's 2^13
    points over 1024 lanes."""
    return ([split(1 << t) + (1 << (19 - t),) for t in range(2, 20)]
            + [split(1 << 20) + (2,), split(1 << 13) + (1024,)])


def parent_row_ms(col2: torch.Tensor) -> None:
    """Where build/parent holds an earlier checkout of the package, its K3
    against this one in this process, in turns parent, this, this, parent,
    each output held equal: on the encode's tensor (``event_ms``, as the
    row is timed), and at the shapes the decode tables give K3
    (``queued_ms``: these take microseconds). Printed for the record."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    if parent_library() is None:
        return
    t = turns(parent_row(col2), lambda: m.row_pass(col2, GF32), event_ms,
              "K3")
    say(f"[encode_r2] K3 against the parent's fecc_row on the same "
        f"{tuple(col2.shape)} tensor, parent / this / this / parent: "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")
    gen = torch.Generator(device=col2.device).manual_seed(6)
    for shape in table_shapes(lambda n: (n // m._split(n), m._split(n))):
        y = rand_field(GF32.p, shape, gen)
        t = turns(parent_row(y), lambda: m.row_pass(y, GF32), queued_ms,
                  "K3")
        say(f"[encode_r2] K3 against the parent's fecc_row on {shape}, "
            f"queued, parent / this / this / parent: {t[0] * 1e3:.2f} / "
            f"{t[1] * 1e3:.2f} / {t[2] * 1e3:.2f} / {t[3] * 1e3:.2f} us")


def parent_col_ms(x3: torch.Tensor, inverse: bool, phase: str) -> None:
    """Where build/parent holds an earlier checkout, its K1 against this
    one on ``x3`` (the path's own tensor), in turns parent, this, this,
    parent (``event_ms``), outputs held equal; printed for the record."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    if parent_library() is None:
        return
    t = turns(parent_col(x3, inverse),
              lambda: m.col_pass(x3, GF32, inverse=inverse), event_ms, "K1")
    say(f"[{phase}] K1 against the parent's fecc_col on the same "
        f"{tuple(x3.shape)} tensor, parent / this / this / parent: "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")


def parent_seam_ms(col1: torch.Tensor, g: int) -> None:
    """As :func:`parent_col_ms`, for K2 on the encode's tensor."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    if parent_library() is None:
        return
    t = turns(parent_seam(col1, g), lambda: m.seam_pass(col1, GF32, g),
              event_ms, "K2")
    say(f"[encode_r2] K2 against the parent's fecc_seam on the same "
        f"{tuple(col1.shape)} tensor, parent / this / this / parent: "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")


def parent_col_pre_ms(x4: torch.Tensor, g: int) -> None:
    """As :func:`parent_col_ms`, for K4 (forward) on the rate-1/4
    encode's tensor."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    if parent_library() is None:
        return
    t = turns(parent_col_pre_vec(x4, False, g=g),
              lambda: m.col_pass_pre(x4, GF32, g), event_ms, "K4")
    say(f"[encode_r4] K4 against the parent's fecc_col_pre on the same "
        f"{tuple(x4.shape)} tensor, parent / this / this / parent: "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")


def parent_decode_ms(x3, lp, col1, col2, dx, ip, mask, orig) -> None:
    """Where build/parent holds an earlier checkout, its K5, K6, K7-sel and
    K7 against this tree's, in turns parent, this, this, parent, outputs
    held equal: on the decode's own tensors (``event_ms``), at decode_blocks'
    2^13 pair shapes over 1024 lanes and K5 at the all-device decode's
    2^13 single transforms, both directions (``queued_ms``, with random
    tables and a mask about half set). Printed for the record."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    if parent_library() is None:
        return
    t = turns(parent_col_pre_vec(x3, True, vec=lp), lambda: m.col_pass_vec(
        x3, GF32, lp, inverse=True), event_ms, "K5")
    say(f"[decode] K5 against the parent's fecc_col_vec on the same "
        f"{tuple(x3.shape)} tensor, parent / this / this / parent: "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")
    t = turns(parent_seam_vec(col1, dx), lambda: m.seam_pass_vec(
        col1, GF32, dx), event_ms, "K6")
    say(f"[decode] K6 against the parent's fecc_seam_vec on the same "
        f"{tuple(col1.shape)} tensor, parent / this / this / parent: "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")
    t = turns(parent_row_post_sel(col2, ip, mask, orig),
              lambda: m.row_pass_post(col2, GF32, ip, mask, orig), event_ms,
              "K7-sel")
    say(f"[decode] K7-sel against the parent's fecc_row_post_sel on the "
        f"same {tuple(col2.shape)} tensor, parent / this / this / parent: "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")
    t = turns(parent_row_post(col2, ip),
              lambda: m.row_pass_post(col2, GF32, ip), event_ms, "K7")
    say(f"[decode] K7 against the parent's fecc_row_post on the same "
        f"{tuple(col2.shape)} tensor, parent / this / this / parent: "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")
    gen = torch.Generator(device="cuda").manual_seed(8)
    n, lanes = 1 << 13, 1024
    c1 = m._pair_split(n)
    v = rand_field(GF32.p, (n,), gen)
    mk = torch.randint(0, 2, (n,), dtype=torch.int32, device="cuda",
                       generator=gen).view(torch.uint32)
    y1 = rand_field(GF32.p, (n // c1, c1, lanes), gen)
    t = turns(parent_seam_vec(y1, v), lambda: m.seam_pass_vec(y1, GF32, v),
              queued_ms, "K6")
    say(f"[decode] K6 against the parent's fecc_seam_vec on "
        f"{tuple(y1.shape)}, queued, parent / this / this / parent: "
        f"{t[0] * 1e3:.2f} / {t[1] * 1e3:.2f} / {t[2] * 1e3:.2f} / "
        f"{t[3] * 1e3:.2f} us")
    y2 = rand_field(GF32.p, (c1, n // c1, lanes), gen)
    o = rand_field(GF32.p, (c1, n // c1, lanes), gen)
    t = turns(parent_row_post_sel(y2, v, mk, o),
              lambda: m.row_pass_post(y2, GF32, v, mk, o), queued_ms,
              "K7-sel")
    say(f"[decode] K7-sel against the parent's fecc_row_post_sel on "
        f"{tuple(y2.shape)}, queued, parent / this / this / parent: "
        f"{t[0] * 1e3:.2f} / {t[1] * 1e3:.2f} / {t[2] * 1e3:.2f} / "
        f"{t[3] * 1e3:.2f} us")
    # K5 at the pair's A1 (the input of K6's shape above), then at the
    # all-device decode's single transforms: inverse, then forward, on
    # [C, R, L] = _split(2^13)
    x5 = rand_field(GF32.p, (c1, n // c1, lanes), gen)
    t = turns(parent_col_pre_vec(x5, True, vec=v), lambda: m.col_pass_vec(
        x5, GF32, v, inverse=True), queued_ms, "K5")
    say(f"[decode] K5 against the parent's fecc_col_vec on "
        f"{tuple(x5.shape)} inverse, queued, parent / this / this / parent: "
        f"{t[0] * 1e3:.2f} / {t[1] * 1e3:.2f} / {t[2] * 1e3:.2f} / "
        f"{t[3] * 1e3:.2f} us")
    c = m._split(n)
    xs = rand_field(GF32.p, (c, n // c, lanes), gen)
    for inv in (True, False):
        t = turns(parent_col_pre_vec(xs, inv, vec=v),
                  lambda: m.col_pass_vec(xs, GF32, v, inverse=inv),
                  queued_ms, "K5")
        say(f"[decode] K5 against the parent's fecc_col_vec on "
            f"{tuple(xs.shape)}{' inverse' if inv else ' forward'}, queued, "
            f"parent / this / this / parent: {t[0] * 1e3:.2f} / "
            f"{t[1] * 1e3:.2f} / {t[2] * 1e3:.2f} / {t[3] * 1e3:.2f} us")


def parent_col_tables_ms() -> None:
    """Where build/parent holds an earlier checkout, its K1 against this
    one at the shapes the decode tables give K1 (``queued_ms``), each
    shape forward and scaled inverse, outputs held equal, summed as the
    tables launch them (per tree level two forward and one inverse; the
    evaluation forward; at 2^13 one of each)."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    if parent_library() is None:
        return
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = table_shapes(lambda n: (m._split(n), n // m._split(n)))
    counts = [(2, 1)] * 18 + [(1, 0), (1, 1)]
    total = [0.0] * 4
    for shape, (n_fwd, n_inv) in zip(shapes, counts):
        x = rand_field(GF32.p, shape, gen)
        for inv, count in ((False, n_fwd), (True, n_inv)):
            if not count:
                continue
            t = turns(parent_col(x, inv),
                      lambda: m.col_pass(x, GF32, inverse=inv), queued_ms,
                      "K1")
            total = [a + count * b for a, b in zip(total, t)]
            say(f"[encode_r2] K1 against the parent's fecc_col on {shape}"
                f"{' inverse' if inv else ''}, queued, parent / this / this "
                f"/ parent: {t[0] * 1e3:.2f} / {t[1] * 1e3:.2f} / "
                f"{t[2] * 1e3:.2f} / {t[3] * 1e3:.2f} us")
    say(f"[encode_r2] K1 at the decode tables' shapes, summed over "
        f"{sum(a + b for a, b in counts)} launches, parent / this / this / "
        f"parent: {total[0]:.4f} / {total[1]:.4f} / {total[2]:.4f} / "
        f"{total[3]:.4f} ms")


def parent_copy_ms(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Where build/parent holds an earlier checkout, its K13 kernel against
    this one, both called straight through the library into ``dst``, in
    turns parent, this, this, parent (``event_ms``); printed for the
    record."""
    from fastecc_tpu_torch.kernels import _build
    lib = parent_library()
    if lib is None:
        return

    def parent():
        code = lib.fecc_copy(src.data_ptr(), dst.data_ptr(), src.numel(),
                             torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"parent fecc_copy returned {code}")

    def this():
        _build.call("fecc_copy", src.data_ptr(), dst.data_ptr(), src.numel(),
                    torch.cuda.current_stream().cuda_stream)

    parent()
    check(torch.equal(dst, src), "parent K13 != clone")
    t = [event_ms(f) for f in (parent, this, this, parent)]
    say(f"[peaks] {src.numel() * 4 >> 20} MiB copy, K13 kernels into one "
        f"output, parent / this / this / parent: {t[0]:.4f} / {t[1]:.4f} / "
        f"{t[2]:.4f} / {t[3]:.4f} ms")


def parent_peaks_ms(x: torch.Tensor, z: torch.Tensor,
                    xf: torch.Tensor) -> None:
    """Where build/parent holds an earlier checkout, its K14 (the solinas,
    generic, raw-mul and raw-add chains at depth 128 on [rows, 128] x, z)
    and K15 (GF32 on xf [c, rows, 128] at depths 2 and 4) against this
    tree's, both called straight through their libraries into one output
    each, held equal, in turns parent, this, this, parent (``event_ms``);
    printed for the record."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import _build
    from fastecc_tpu_torch.kernels import microbench as mb
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    lib = parent_library()
    if lib is None:
        return
    stream = torch.cuda.current_stream().cuda_stream
    out, out_p = torch.empty_like(x), torch.empty_like(x)
    for v in ("solinas", "generic", "raw-mul", "raw-add"):
        code = mb._VARIANT_CODE[v]

        def parent():
            rc = lib.fecc_chain(code, x.data_ptr(), z.data_ptr(),
                                out_p.data_ptr(), x.shape[0], 128, stream)
            check(rc == 0, f"parent fecc_chain returned {rc}")
            return out_p

        def this():
            _build.call("fecc_chain", code, x.data_ptr(), z.data_ptr(),
                        out.data_ptr(), x.shape[0], 128, stream)
            return out
        t = turns(parent, this, event_ms, f"K14 {v}")
        say(f"[peaks] K14 {v} [{x.shape[0]}, 128] depth 128, parent / this "
            f"/ this / parent: {t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / "
            f"{t[3]:.4f} ms")
    del out, out_p
    c, lanes = xf.shape[0], xf.numel() // xf.shape[0]
    dev = str(xf.device)
    inner = m._row_tw_on(GF32.name, c, False, dev)
    out, out_p = torch.empty_like(xf), torch.empty_like(xf)
    for depth in (2, 4):
        def parent():
            rc = lib.fecc_fused_chain(0, xf.data_ptr(), out_p.data_ptr(), c,
                                      lanes, inner.data_ptr(), depth, stream)
            check(rc == 0, f"parent fecc_fused_chain returned {rc}")
            return out_p

        def this():
            _build.call("fecc_fused_chain", 0, xf.data_ptr(),
                        out.data_ptr(), c, lanes, inner.data_ptr(), depth,
                        stream)
            return out
        t = turns(parent, this, event_ms, f"K15 depth {depth}")
        say(f"[peaks] K15 GF32 {list(xf.shape)} depth {depth}, parent / "
            f"this / this / parent: {t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / "
            f"{t[3]:.4f} ms")


def parent_wire16_ms(x3: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                     g: int) -> None:
    """Where build/parent holds an earlier checkout, its K8, K9 and K10
    (each with the inner twiddles) against this tree's on the wire16
    phase's tensors (the pairs, then each pass's [2, ...] input), outputs
    held equal, in turns parent, this, this, parent (``event_ms``);
    printed for the record."""
    from fastecc_tpu_torch.fields import GF16
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    lib = parent_library()
    if lib is None:
        return
    dev = str(h1.device)
    stream = torch.cuda.current_stream().cuda_stream
    c, r, lanes = x3.shape
    tr = m._seed_tr(r)
    tw = m._row_tw_on(GF16.name, c, True, dev)
    seed, t0 = m._seeds_on(GF16.name, c * r, c, True, True, tr, dev)
    out8 = torch.empty((2, r, c, lanes), dtype=torch.uint32, device=dev)

    def parent8():
        code = lib.fecc_col_wire16(
            1, x3.data_ptr(), out8.data_ptr(), c, r, lanes, tw.data_ptr(),
            seed.data_ptr(), t0.data_ptr(), tr, stream)
        check(code == 0, f"parent fecc_col_wire16 returned {code}")
        return out8
    t = turns(parent8, lambda: m.col_pass_wire16(x3, GF16), event_ms, "K8")
    say(f"[wire16] K8 against the parent's fecc_col_wire16 on the same "
        f"{tuple(x3.shape)} pairs, parent / this / this / parent: "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")
    _, r1, c1, _ = h1.shape
    tr = m._seed_tr(c1)
    tw_inv = m._row_tw_on(GF16.name, r1, True, dev)
    tw_fwd = m._row_tw_on(GF16.name, r1, False, dev)
    seed, t0 = m._seeds_on(GF16.name, r1 * c1, r1, False, False, tr, dev)
    pcol, prow = m._pre_on(GF16.name, g % GF16.p, r1, c1, tr, dev)
    out9 = torch.empty((2, c1, r1, lanes), dtype=torch.uint32, device=dev)

    def parent9():
        code = lib.fecc_seam_wire16(
            1, h1.data_ptr(), out9.data_ptr(), r1, c1, lanes,
            tw_inv.data_ptr(), tw_fwd.data_ptr(), seed.data_ptr(),
            t0.data_ptr(), tr, pcol.data_ptr(), prow.data_ptr(), stream)
        check(code == 0, f"parent fecc_seam_wire16 returned {code}")
        return out9
    t = turns(parent9, lambda: m.seam_pass_wire16(h1, GF16, g), event_ms,
              "K9")
    say(f"[wire16] K9 against the parent's fecc_seam_wire16 on the same "
        f"{tuple(h1.shape)} tensor, parent / this / this / parent: "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")
    _, r2, c2, _ = h2.shape
    tw = m._row_tw_on(GF16.name, r2, False, dev)
    stored = torch.empty((r2 * c2, lanes), dtype=torch.uint32, device=dev)
    bitmap = torch.empty((r2 * c2, lanes // 8), dtype=torch.uint32,
                         device=dev)

    def parent10():
        code = lib.fecc_row_wire16(
            1, h2[0].data_ptr(), h2[1].data_ptr(), stored.data_ptr(),
            bitmap.data_ptr(), r2, c2, lanes, tw.data_ptr(), stream)
        check(code == 0, f"parent fecc_row_wire16 returned {code}")
        return stored, bitmap

    def this10():
        return m.wire16_pass_b2(h2[0], h2[1], GF16)
    check(same(parent10(), this10()), "parent K10 != this K10")
    t = [event_ms(f) for f in (parent10, this10, this10, parent10)]
    say(f"[wire16] K10 against the parent's fecc_row_wire16 on the same "
        f"{tuple(h2.shape)} tensor, parent / this / this / parent: "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")


def parent_lanes_wire16_ms(words: torch.Tensor, g: int) -> None:
    """As :func:`parent_wire16_ms`, for K12 (``fecc_pair_lanes_wire16``
    with its level and inner twiddles) on the lanes phase's [k, Wu] pairs:
    both parts held equal, the parent's and this tree's calls timed in
    turns."""
    from fastecc_tpu_torch.fields import GF16
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    lib = parent_library()
    if lib is None:
        return
    k, wu = words.shape
    tables = [None if t is None else t.data_ptr() for t in
              m._lanes_tables_on(GF16.name, k, g % GF16.p,
                                 m.K12_TWO_EXCHANGE_K, str(words.device))]
    stored = torch.empty_like(words)
    bitmap = torch.empty((k, wu // 8), dtype=torch.uint32,
                         device=words.device)

    def parent():
        code = lib.fecc_pair_lanes_wire16(
            1, words.data_ptr(), stored.data_ptr(), bitmap.data_ptr(), k, wu,
            *tables, torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"parent fecc_pair_lanes_wire16 returned {code}")
        return stored, bitmap

    def this():
        return m.ntt_pair_lanes_wire16(words, GF16, g)
    check(same(parent(), this()), "parent K12 != this K12")
    t = [event_ms(f) for f in (parent, this, this, parent)]
    say(f"[lanes_wire16] K12 against the parent's fecc_pair_lanes_wire16 on "
        f"the same {tuple(words.shape)} pairs, parent / this / this / "
        f"parent: {t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")


def parent_lanes_ms(flat: torch.Tensor, g: int) -> None:
    """As :func:`parent_wire16_ms`, for K11 (``fecc_pair_lanes`` with its
    level and inner tables) on the lanes phase's GF32 [2^10, 65536]: the
    outputs held equal, the parent's and this tree's calls timed in
    turns."""
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    lib = parent_library()
    if lib is None:
        return
    k, lanes = flat.shape
    dev = str(flat.device)
    tables = [None if t is None else t.data_ptr() for t in
              m._lanes_tables_on(GF32.name, k, g % GF32.p,
                                 m.K11_TWO_EXCHANGE_K, dev)]
    out = torch.empty_like(flat)

    def parent():
        code = lib.fecc_pair_lanes(
            0, flat.data_ptr(), out.data_ptr(), k, lanes, *tables,
            torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"parent fecc_pair_lanes returned {code}")
        return out
    t = turns(parent, lambda: m.ntt_pair_lanes(flat, GF32, g), event_ms,
              "K11")
    say(f"[lanes] K11 against the parent's fecc_pair_lanes on the same "
        f"{tuple(flat.shape)} tensor, parent / this / this / parent: "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms")


def phase_ntt(gen, launches, times):
    from fastecc_tpu_torch import ntt
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    from fastecc_tpu_torch.utils.timer import median, time_samples

    n, lanes = 1 << 20, 512
    x = rand_field(GF32.p, (n, lanes), gen)
    y = run_path("ntt", lambda: ntt.ntt_auto(x, GF32), launches,
                 ("K1_col", "K3_row"))
    check(all_below_p(y, GF32.p), "NTT values < p")
    check_edge_lanes("ntt", y, lambda v: ntt.ntt(v, GF32, radix=4), x)
    del y
    samples = time_samples(lambda: ntt.ntt_auto(x, GF32), iters=5, warmup=1)
    times["ntt_s"] = median(samples)
    say(f"[ntt] 2^20 x 512 median {times['ntt_s'] * 1e3:.3f} ms of "
        f"{[round(s * 1e3, 3) for s in samples]}")
    profile_once(lambda: ntt.ntt_auto(x, GF32), "ntt")
    c = m._split(n)
    parent_col_ms(x.reshape(c, n // c, lanes), False, "ntt")
    del x
    torch.cuda.empty_cache()


def phase_wire(gen, launches, times):
    from fastecc_tpu_torch import packing, rs
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.utils.timer import median, time_samples

    k, block = 1 << 14, 4096
    raw = torch.randint(0, 256, (k, block), dtype=torch.uint8,
                        device="cuda", generator=gen)
    raw[0] = 0xFF                                     # all-escape block
    blob = run_path("wire", lambda: rs.encode_blocks(raw, GF32), launches,
                    ("K1_col", "K2_seam", "K3_row"))
    check(tuple(blob.shape) == (k, packing.parity_bytes(GF32, block)),
          "wire parity shape")
    packed = packing.pack_data(raw, GF32)
    want = rs.encode_parity(packed, GF32)
    check(torch.equal(packing.deserialize_parity(blob, GF32), want),
          "deserialize(encode_blocks) != encode_parity(pack_data)")
    check_edge_lanes("wire", want, lambda x: staged_encode_ref(x, GF32, 2 * k),
                     packed)
    parts = rs.encode_blocks_parts(raw.view(torch.uint32), GF32)
    check(torch.equal(parts.view(torch.uint8), blob),
          "encode_blocks_parts byte image != encode_blocks")
    say("[wire] deserialize(encode_blocks) == encode_parity(pack_data); "
        "parts form agrees")
    samples = time_samples(lambda: rs.encode_blocks(raw, GF32), iters=5,
                           warmup=1)
    times["wire_s"] = median(samples)
    say(f"[wire] 2^14 x 4 KB blocks median {times['wire_s'] * 1e3:.3f} ms")
    profile_once(lambda: rs.encode_blocks(raw, GF32), "wire")


def wire16_edge_ref(words: torch.Tensor, n: int):
    """(stored, bitmap word) of 8 lanes of u32 pairs from the plain staged
    transforms: each half encoded on its own, then re-packed."""
    from fastecc_tpu_torch import gf
    from fastecc_tpu_torch.fields import GF16
    x = gf.widen(words)
    lo, hi = (gf.widen(staged_encode_ref(gf.narrow(h), GF16, n))
              for h in (x & 0xFFFF, x >> 16))
    shifts = 2 * torch.arange(8, device=x.device)
    bits = ((lo >> 16) << shifts) | ((hi >> 16) << (shifts + 1))
    return (gf.narrow((lo & 0xFFFF) | ((hi & 0xFFFF) << 16)),
            gf.narrow(bits.sum(dim=1)))


def generic_wire16(raw: torch.Tensor) -> torch.Tensor:
    """The generic GF16 route, an independent composition: pack_data ->
    encode_parity (K1 -> K2 -> K3) -> serialize_parity."""
    from fastecc_tpu_torch import packing, rs
    from fastecc_tpu_torch.fields import GF16
    return packing.serialize_parity(
        rs.encode_parity(packing.pack_data(raw, GF16), GF16), GF16)


def phase_wire16(gen, launches, times, shapes):
    from fastecc_tpu_torch import gf, rs
    from fastecc_tpu_torch.fields import GF16
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    from fastecc_tpu_torch.utils.timer import median, time_samples

    # bench.py:244: GF16, 2^13 blocks of 64 KB (2^14 u32 pairs per block)
    k, block = 1 << 13, 1 << 16
    n, wu = 2 * k, block // 4
    raw = torch.randint(0, 256, (k, block), dtype=torch.uint8, device="cuda",
                        generator=gen)
    words = raw.view(torch.uint32)
    stored, bm = run_path("wire16", lambda: rs.encode_blocks_gf16_parts(words),
                          launches, WIRE16)
    check(tuple(stored.shape) == (k, wu) and tuple(bm.shape) == (k, wu // 8),
          "wire16 parts shapes")
    wire = run_path("wire16_generic", lambda: generic_wire16(raw), launches,
                    ("K1_col", "K2_seam", "K3_row"))
    check(torch.equal(rs.wire_gf16_from_parts(stored, bm), wire),
          "encode_blocks_gf16_parts != the generic route's wire bytes")
    esc = int((gf.widen(bm) != 0).sum().item())
    check(esc > 0, "no escape bits at the wire16 shape")
    del wire
    for l0 in (0, wu - 8):
        st_ref, bm_ref = wire16_edge_ref(words[:, l0:l0 + 8].contiguous(), n)
        check(torch.equal(stored[:, l0:l0 + 8], st_ref)
              and torch.equal(bm[:, l0 // 8], bm_ref),
              f"wire16 lanes {l0}-{l0 + 7} != plain staged")
    say(f"[wire16] parts == the generic route's wire bytes on all {wu} "
        f"pair lanes ({esc} bitmap words with escapes); lanes 0-7 and "
        f"{wu - 8}-{wu - 1} == plain staged transforms")
    del stored, bm
    samples = time_samples(lambda: rs.encode_blocks_gf16_parts(words),
                           iters=5, warmup=1)
    t = median(samples)
    times["wire16_s"] = t
    times["wire16_gbps"] = n * block / t / 1e9
    gsamples = time_samples(lambda: generic_wire16(raw), iters=3, warmup=1)
    times["wire16_generic_s"] = median(gsamples)
    say(f"[wire16] 2^13 x 64 KB median {t * 1e3:.3f} ms of "
        f"{[round(s * 1e3, 3) for s in samples]} -> "
        f"{times['wire16_gbps']:.2f} GB/s wire (n*B); the generic route "
        f"{times['wire16_generic_s'] * 1e3:.3f} ms (a figure, not a claim)")
    profile_once(lambda: rs.encode_blocks_gf16_parts(words), "wire16")

    # per-kernel device times at the main-path shapes
    g = GF16.root_of_order(n)
    x3 = words.reshape(m._pair_split(k), -1, wu)
    h1 = m.col_pass_wire16(x3, GF16)
    h2 = m.seam_pass_wire16(h1, GF16, g)
    times["K8_col_wire16"] = event_ms(lambda: m.col_pass_wire16(x3, GF16))
    times["K9_seam_wire16"] = event_ms(lambda: m.seam_pass_wire16(h1, GF16, g))
    times["K10_row_wire16"] = event_ms(
        lambda: m.wire16_pass_b2(h2[0], h2[1], GF16))
    shapes["K8_col_wire16"] = tuple(x3.shape)
    shapes["K9_seam_wire16"] = tuple(h1.shape[1:])
    shapes["K10_row_wire16"] = tuple(h2.shape[1:])
    times["plain_K8_col_wire16"] = chunked_ms(
        lambda x: m.col_pass_wire16_plain(x, GF16), x3, 128)
    times["plain_K9_seam_wire16"] = chunked_ms(
        lambda y: m.seam_pass_wire16_plain(y, GF16, g), h1, 128)
    times["plain_K10_row_wire16"] = chunked_ms(
        lambda lo, hi: m.row_pass_wire16_plain(lo, hi, GF16), h2[0], 128,
        h2[1])
    for kk in WIRE16:
        say(f"[wire16] {kk} {times[kk]:.3f} ms on {shapes[kk]} per half, "
            f"plain {times['plain_' + kk]:.1f} ms")
    parent_wire16_ms(x3, h1, h2, g)
    del x3, h1, h2

    # encode_blocks, bytes in and out, at the default 4 KB wire format
    raw4 = raw[:, :4096].contiguous()
    del raw, words
    blob = run_path("wire16_blocks", lambda: rs.encode_blocks(raw4, GF16),
                    launches, WIRE16)
    check(blob.dtype == torch.uint8 and torch.equal(blob,
                                                    generic_wire16(raw4)),
          "GF16 encode_blocks != the generic route's bytes")
    say(f"[wire16_blocks] encode_blocks 2^13 x 4 KB == the generic route's "
        f"{tuple(blob.shape)} bytes")
    del raw4, blob
    torch.cuda.empty_cache()


def garbage_rows(cw: torch.Tensor, erased: np.ndarray, p: int, gen):
    """A copy of ``cw`` with the rows in ``erased`` overwritten by random
    field values (the decoder must not read them)."""
    bad = cw.clone()
    rows = torch.from_numpy(erased).cuda()
    bad.view(torch.int32)[rows] = rand_field(
        p, (len(erased), cw.shape[1]), gen).view(torch.int32)
    return bad


def phase_decode(gen, launches, times, shapes):
    from fastecc_tpu_torch import decode, rs, testing
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    from fastecc_tpu_torch.utils.timer import median, time_samples

    k, lanes = 1 << 19, 512
    n = 2 * k
    cw = rs.encode(rand_field(GF32.p, (k, lanes), gen), GF32, n)
    erased = testing.random_erasures(n, n - k, seed=0x5EED)
    bad = garbage_rows(cw, erased, GF32.p, gen)
    check(not torch.equal(bad, cw), "garbage rows differ from the codeword")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tabs = run_path("decode_tables", lambda: decode.prepare_decode_tables(
        erased, n, GF32), launches, ("K1_col", "K3_row"))
    times["tables_s"] = time.perf_counter() - t0
    mask, lp, ip = tabs
    check(int(gf_sum(mask)) == n - k, "mask marks the erased rows")
    say(f"[decode] device tables for e = 2^19 in {times['tables_s']:.3f} s")

    out = run_path("decode", lambda: decode.decode_prepared(bad, *tabs, GF32),
                   launches, ("K5_col_vec", "K6_seam_vec", "K7_row_post_sel"))
    check({kk: v for kk, v in launches["decode"].items() if v} == {
        "K5_col_vec": 1, "K6_seam_vec": 1, "K7_row_post_sel": 1},
        "decode_prepared runs exactly K5 -> K6 -> K7-sel")
    check(torch.equal(out, cw), "decode_prepared != the encoder's codeword")
    say(f"[decode] decode_prepared == rs.encode's codeword on all {lanes} "
        f"lanes, {n - k} erased rows")
    del out
    raw = run_path("decode_nomerge", lambda: decode.decode_prepared(
        bad, *tabs, GF32, merge=False), launches,
        ("K5_col_vec", "K6_seam_vec", "K7_row_post"))
    rows = torch.from_numpy(erased).cuda()
    check(torch.equal(raw.view(torch.int32)[rows], cw.view(torch.int32)[rows]),
          "merge=False erased rows != the codeword")
    say("[decode_nomerge] erased rows == the codeword")
    del raw, rows
    samples = time_samples(lambda: decode.decode_prepared(bad, *tabs, GF32),
                           iters=5, warmup=1)
    t = median(samples)
    times["decode_s"] = t
    times["decode_gbps"] = n * lanes * 4 / t / 1e9
    say(f"[decode] median {t * 1e3:.3f} ms of "
        f"{[round(x * 1e3, 3) for x in samples]} -> "
        f"{times['decode_gbps']:.2f} GB/s codeword")
    profile_once(lambda: decode.decode_prepared(bad, *tabs, GF32), "decode")

    # per-kernel device times at the main-path shapes
    dx = decode._xderiv_on(GF32.name, n, "cuda:0")
    c1 = m._pair_split(n)
    r1 = n // c1
    x3 = bad.reshape(c1, r1, lanes)
    orig = bad.reshape(c1, r1, lanes)          # [R2, C2, L] = [C1, R1, L]
    col1 = m.col_pass_vec(x3, GF32, lp, inverse=True)
    col2 = m.seam_pass_vec(col1, GF32, dx)
    times["K5_col_vec"] = event_ms(
        lambda: m.col_pass_vec(x3, GF32, lp, inverse=True))
    times["K6_seam_vec"] = event_ms(lambda: m.seam_pass_vec(col1, GF32, dx))
    times["K7_row_post"] = event_ms(lambda: m.row_pass_post(col2, GF32, ip))
    times["K7_row_post_sel"] = event_ms(
        lambda: m.row_pass_post(col2, GF32, ip, mask, orig))
    for kk, sh in (("K5_col_vec", x3), ("K6_seam_vec", col1),
                   ("K7_row_post", col2), ("K7_row_post_sel", col2)):
        shapes[kk] = tuple(sh.shape)
    times["sel_frac"] = (n - k) / n
    times["plain_K5_col_vec"] = chunked_ms(
        lambda x: m.col_pass_plain(x, GF32, inverse=True, pre_vec=lp), x3,
        128)
    times["plain_K6_seam_vec"] = chunked_ms(
        lambda x: m.seam_pass_plain(x, GF32, pre_vec2=dx), col1, 128)
    times["plain_K7_row_post"] = chunked_ms(
        lambda x: m.row_pass_plain(x, GF32, post_vec=ip), col2, 128)
    times["plain_K7_row_post_sel"] = chunked_ms(
        lambda x, o: m.row_pass_plain(x, GF32, post_vec=ip, sel_mask=mask,
                                      sel_orig=o), col2, 128, orig)
    for kk in ("K5_col_vec", "K6_seam_vec", "K7_row_post", "K7_row_post_sel"):
        say(f"[decode] {kk} {times[kk]:.3f} ms on {shapes[kk]}, "
            f"plain {times['plain_' + kk]:.1f} ms")
    # the epilogue's cost: K3 on K7-sel's tensor, in turns with K7-sel
    t = [event_ms(f) for f in (
        lambda: m.row_pass(col2, GF32),
        lambda: m.row_pass_post(col2, GF32, ip, mask, orig),
        lambda: m.row_pass_post(col2, GF32, ip, mask, orig),
        lambda: m.row_pass(col2, GF32))]
    say(f"[decode] K3 / K7-sel / K7-sel / K3 on the same "
        f"{tuple(col2.shape)} tensor: {t[0]:.4f} / {t[1]:.4f} / "
        f"{t[2]:.4f} / {t[3]:.4f} ms")
    parent_decode_ms(x3, lp, col1, col2, dx, ip, mask, orig)
    del cw, bad, x3, orig, col1, col2, tabs, mask, lp, ip
    torch.cuda.empty_cache()


def phase_decode_small(gen, launches, times):
    from fastecc_tpu_torch import decode, packing, rs, testing
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.utils.timer import median, time_samples

    # BASELINE.json:10: 2^12 of 2^13 lost, the all-device decode
    k, lanes = 1 << 12, 1024
    n = 2 * k
    cw = rs.encode(rand_field(GF32.p, (k, lanes), gen), GF32, n)
    erased = testing.random_erasures(n, n - k, seed=10)
    bad = garbage_rows(cw, erased, GF32.p, gen)
    out = run_path("decode_small", lambda: decode.decode(bad, erased, GF32,
                                                         k=k), launches,
                   ("K1_col", "K3_row", "K5_col_vec", "K7_row_post_sel"))
    check(torch.equal(out, cw), "decode (all-device) != codeword")
    samples = time_samples(lambda: decode.decode(bad, erased, GF32, k=k),
                           iters=3, warmup=0)
    times["decode_small_s"] = median(samples)
    say(f"[decode_small] decode 2^13 x {lanes}, e = 2^12 == codeword; "
        f"median {times['decode_small_s'] * 1e3:.3f} ms (tables included)")
    del cw, bad, out

    # decode_blocks over exactly k survivors, data and parity mixed
    block = 4096
    raw = torch.randint(0, 256, (k, block), dtype=torch.uint8, device="cuda",
                        generator=gen)
    raw[0] = 0xFF                                     # all-escape block
    parity = rs.encode_blocks(raw, GF32)
    raw_np, par_np = raw.cpu().numpy(), parity.cpu().numpy()
    rng = np.random.default_rng(0xB10C)
    keep = np.concatenate([[0], rng.choice(np.arange(1, n), size=k - 1,
                                           replace=False)])
    dpos = set(rs.data_positions(n, k).tolist())
    ppos = {int(p): i for i, p in enumerate(rs.parity_positions(n, k))}
    surv = {int(p): (raw_np[p // 2] if p in dpos else par_np[ppos[p]]
                     ).tobytes() for p in keep}
    n_data = sum(int(p) in dpos for p in keep)
    got = run_path("decode_blocks", lambda: decode.decode_blocks(
        surv, n, k, GF32), launches,
        ("K5_col_vec", "K6_seam_vec", "K7_row_post_sel"))
    check(torch.equal(got, raw), "decode_blocks != the raw blocks")
    say(f"[decode_blocks] {k} survivors ({n_data} data, {k - n_data} "
        f"parity) of {n} 4 KB blocks == the raw bytes")
    del raw, parity, got, surv

    # GF32 wire decode, parts form, at n = 2^18 (bench.py:297)
    kw = 1 << 17
    words = torch.randint(-(1 << 31), 1 << 31, (kw, block // 4),
                          dtype=torch.int32, device="cuda",
                          generator=gen).view(torch.uint32)
    par = rs.encode_blocks_parts(words, GF32)
    check(tuple(par.shape) == (kw, packing.parity_bytes(GF32, block) // 4),
          "wire parity parts shape")
    dw = run_path("wire_decode", lambda: decode.decode_wire_parts(
        par, 2 * kw, kw, GF32), launches, ("K1_col", "K2_seam", "K3_row"))
    check(torch.equal(dw, words), "decode_wire_parts != the raw blocks")
    samples = time_samples(lambda: decode.decode_wire_parts(
        par, 2 * kw, kw, GF32), iters=5, warmup=1)
    times["wire_decode_s"] = median(samples)
    say(f"[wire_decode] 2^17 x 4 KB blocks from parity == raw; median "
        f"{times['wire_decode_s'] * 1e3:.3f} ms")
    del words, par, dw
    torch.cuda.empty_cache()


def phase_extras(gen, launches, times):
    from fastecc_tpu_torch import decode, gf, rs, testing
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.interop import to_numpy_u32 as host_u32
    from fastecc_tpu_torch.utils.timer import median, time_samples

    # verify_codeword on phase 4's full-width codeword, then one word off
    k, lanes = 1 << 19, 1024
    n = 2 * k
    data = rand_field(GF32.p, (k, lanes), gen)
    cw = rs.encode(data, GF32, n)
    ok = run_path("verify", lambda: rs.verify_codeword(cw, GF32, k),
                  launches, ("K1_col", "K3_row"))
    check(bool(ok), "verify_codeword(encode(data)) is False")
    times["verify_s"] = median(time_samples(
        lambda: rs.verify_codeword(cw, GF32, k), iters=3, warmup=0))
    word = cw.view(torch.int32)[12345:12346, 678:679]
    word.copy_(gf.narrow((gf.widen(word.view(torch.uint32)) + 1)
                         % GF32.p).view(torch.int32))
    check(not bool(rs.verify_codeword(cw, GF32, k)),
          "verify_codeword misses a changed word")
    say(f"[verify] 2^20 x 1024 codeword: True, False after one word "
        f"changes; {times['verify_s'] * 1e3:.3f} ms")
    del cw

    # a partial-stripe write of three blocks at the same width
    par = rs.encode_parity(data, GF32, n)
    idxs = (0, 12345, k - 1)
    rows = torch.tensor(idxs, device="cuda")
    old = data.view(torch.int32)[rows].view(torch.uint32)
    new = rand_field(GF32.p, (len(idxs), lanes), gen)
    upd = run_path("update_parity", lambda: rs.update_parity_multi(
        par, idxs, old, new, GF32), launches, ())
    data.view(torch.int32)[rows] = new.view(torch.int32)
    check(torch.equal(upd, rs.encode_parity(data, GF32, n)),
          "update_parity_multi != re-encode")
    times["update_s"] = median(time_samples(lambda: rs.update_parity_multi(
        par, idxs, old, new, GF32), iters=3, warmup=0))
    say(f"[update_parity] 3 of 2^19 blocks x 1024 lanes == re-encode; "
        f"{times['update_s'] * 1e3:.3f} ms")
    del data, par, old, new, upd
    torch.cuda.empty_cache()

    # many small stripes in one encode
    batch = rand_field(GF32.p, (16, 1 << 13, 64), gen)
    got = run_path("batch", lambda: rs.encode_parity_batch(batch, GF32),
                   launches, ("K1_col", "K2_seam", "K3_row"))
    for i in range(batch.shape[0]):
        check(torch.equal(got[i], rs.encode_parity(batch[i], GF32)),
              f"encode_parity_batch stripe {i} != its own encode")
    say("[batch] 16 stripes of 2^13 x 64 == per-stripe encode_parity")

    # out-of-core streams over lane chunks: host arrays in and out
    ks, ls = 1 << 16, 2048
    ns = 2 * ks
    host = host_u32(rand_field(GF32.p, (ks, ls), gen))
    sp = run_path("encode_stream", lambda: rs.encode_parity_stream(
        host, GF32, chunk_lanes=512), launches,
        ("K1_col", "K2_seam", "K3_row"))
    check(np.array_equal(sp, host_u32(rs.encode_parity(host, GF32))),
          "encode_parity_stream != one encode_parity")
    times["encode_stream_s"] = median(time_samples(
        lambda: rs.encode_parity_stream(host, GF32, chunk_lanes=512),
        iters=3, warmup=0))
    times["encode_onecall_s"] = median(time_samples(
        lambda: host_u32(rs.encode_parity(host, GF32)), iters=3, warmup=0))
    cwh = host_u32(rs.encode(host, GF32))
    erased = testing.random_erasures(ns, ns - ks, seed=0x57)
    bad = cwh.copy()
    bad[erased] = 0x12345
    ds = run_path("decode_stream", lambda: decode.decode_stream(
        bad, erased, GF32, chunk_lanes=512), launches,
        ("K5_col_vec", "K6_seam_vec", "K7_row_post_sel"))
    check(np.array_equal(ds, cwh), "decode_stream != the codeword")
    times["decode_stream_s"] = median(time_samples(
        lambda: decode.decode_stream(bad, erased, GF32, chunk_lanes=512),
        iters=3, warmup=0))
    say(f"[streams] encode_parity_stream 2^16 x {ls} (4 chunks) == one "
        f"call: {times['encode_stream_s'] * 1e3:.3f} ms (one call with its "
        f"copies {times['encode_onecall_s'] * 1e3:.3f} ms); decode_stream "
        f"2^17 x {ls}, e = 2^16 == the codeword: "
        f"{times['decode_stream_s'] * 1e3:.3f} ms (tables included)")
    torch.cuda.empty_cache()


@contextlib.contextmanager
def lanes_pair(on: bool):
    """The lanes pair switched on or off (ntt_mfa.LANES_PAIR_ENABLED, the
    reference's FASTECC_LANES_PAIR opt-in) for the block; restored after."""
    from fastecc_tpu_torch.kernels import ntt_mfa
    was = ntt_mfa.LANES_PAIR_ENABLED
    ntt_mfa.LANES_PAIR_ENABLED = on
    try:
        yield
    finally:
        ntt_mfa.LANES_PAIR_ENABLED = was


def same(a, b) -> bool:
    """torch.equal, also over tuples of tensors (the wire parts)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(torch.equal, a, b))
    return torch.equal(a, b)


def phase_lanes(gen, launches, times, shapes):
    from fastecc_tpu_torch import decode, gf, rs
    from fastecc_tpu_torch.fields import GF16, GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m
    from fastecc_tpu_torch.utils.timer import median, time_samples

    three_pass = ("K1_col", "K2_seam", "K3_row")

    def routes(name, fn, lanes_kernel, off_kernels=three_pass):
        """fn() with the lanes pair on (which must launch ``lanes_kernel``
        and nothing else) and off (the three-pass route), held equal on
        every lane; then median of 5 timed calls of each route."""
        with lanes_pair(True):
            got = run_path(name, fn, launches, (lanes_kernel,))
        check(set(k for k, v in launches[name].items() if v) == {lanes_kernel},
              f"{name} launches only {lanes_kernel}")
        with lanes_pair(False):
            want = run_path(name + "_3pass", fn, launches, off_kernels)
        check(same(got, want), f"{name}: the lanes route != the three-pass "
              f"route")
        for on in (True, False):
            with lanes_pair(on):
                t = median(time_samples(fn, iters=5, warmup=1))
            times[f"{name}_{'lanes' if on else '3pass'}_s"] = t
        say(f"[{name}] lanes route == three-pass route on every lane; median "
            f"{times[name + '_lanes_s'] * 1e3:.3f} ms (lanes) against "
            f"{times[name + '_3pass_s'] * 1e3:.3f} ms (three passes)")
        return got

    # the GF32 batch encode: 64 stripes at BASELINE.json:7's shape (2^10
    # data + 2^10 parity 4 KB blocks, 1024 lanes each): 65,536 lanes
    s, k, lanes = 64, 1 << 10, 1024
    batch = rand_field(GF32.p, (s, k, lanes), gen)
    got = routes("lanes", lambda: rs.encode_parity_batch(batch, GF32),
                 "K11_pair_lanes")
    for si, l0 in ((0, 0), (s - 1, lanes - 8)):
        ref = staged_encode_ref(batch[si][:, l0:l0 + 8].contiguous(), GF32,
                                2 * k)
        check(torch.equal(got[si][:, l0:l0 + 8], ref),
              f"lanes batch stripe {si} lanes {l0}-{l0 + 7} != plain staged")
    say(f"[lanes] stripe 0 lanes 0-7 and stripe {s - 1} lanes "
        f"{lanes - 8}-{lanes - 1} == plain staged transforms")
    del got
    with lanes_pair(True):
        profile_once(lambda: rs.encode_parity_batch(batch, GF32), "lanes")
    # K11 alone at the batch's shape, beside the three passes' kernels
    g = GF32.root_of_order(2 * k)
    flat = batch.view(torch.int32).movedim(0, 1).reshape(k, s * lanes).view(
        torch.uint32)
    times["K11_pair_lanes"] = event_ms(lambda: m.ntt_pair_lanes(flat, GF32, g))
    times["lanes_kernels_3pass"] = event_ms(
        lambda: m.ntt_pair(flat, GF32, pre_seed2=g))
    shapes["K11_pair_lanes"] = tuple(flat.shape)
    times["plain_K11_pair_lanes"] = chunked_ms(
        lambda x: m.pair_lanes_plain(x, GF32, g), flat, 1024)
    say(f"[lanes] K11_pair_lanes {times['K11_pair_lanes']:.4f} ms on "
        f"{shapes['K11_pair_lanes']} (K1 -> K2 -> K3: "
        f"{times['lanes_kernels_3pass']:.4f} ms), plain "
        f"{times['plain_K11_pair_lanes']:.1f} ms")
    parent_lanes_ms(flat, g)
    del batch, flat

    # GF32 at the top of the gate
    k13 = 1 << 13
    data = rand_field(GF32.p, (k13, 1024), gen)
    got = routes("lanes_k8192", lambda: rs.encode_parity(data, GF32),
                 "K11_pair_lanes")
    check_edge_lanes("lanes_k8192", got,
                     lambda x: staged_encode_ref(x, GF32, 2 * k13), data)
    del data, got

    # the GF32 wire decode at n = 2^13, 4 KB blocks (K11, inverse seed)
    kw = 1 << 12
    words = torch.randint(-(1 << 31), 1 << 31, (kw, 1024), dtype=torch.int32,
                          device="cuda", generator=gen).view(torch.uint32)
    par = rs.encode_blocks_parts(words, GF32)
    dw = routes("lanes_wire_decode", lambda: decode.decode_wire_parts(
        par, 2 * kw, kw, GF32), "K11_pair_lanes")
    check(torch.equal(dw, words), "lanes wire decode != the raw blocks")
    say("[lanes_wire_decode] n = 2^13 x 4 KB blocks from parity == raw")
    del words, par, dw

    # the GF16 wire encode at the wire16 cell's shape (bench.py:244)
    k16, block = 1 << 13, 1 << 16
    raw = torch.randint(0, 256, (k16, block), dtype=torch.uint8,
                        device="cuda", generator=gen)
    words = raw.view(torch.uint32)
    stored, bm = routes("lanes_wire16",
                        lambda: rs.encode_blocks_gf16_parts(words),
                        "K12_pair_lanes_wire16", WIRE16)
    esc = int((gf.widen(bm) != 0).sum().item())
    check(esc > 0, "no escape bits at the lanes wire16 shape")
    say(f"[lanes_wire16] {esc} bitmap words with escapes")
    del stored, bm
    with lanes_pair(True):
        profile_once(lambda: rs.encode_blocks_gf16_parts(words),
                     "lanes_wire16")
    g16 = GF16.root_of_order(2 * k16)
    times["K12_pair_lanes_wire16"] = event_ms(
        lambda: m.ntt_pair_lanes_wire16(words, GF16, g16))
    shapes["K12_pair_lanes_wire16"] = tuple(words.shape)
    times["plain_K12_pair_lanes_wire16"] = chunked_ms(
        lambda x: m.pair_lanes_wire16_plain(x, GF16, g16), words, 128)
    say(f"[lanes_wire16] K12_pair_lanes_wire16 "
        f"{times['K12_pair_lanes_wire16']:.4f} ms on "
        f"{shapes['K12_pair_lanes_wire16']}, plain "
        f"{times['plain_K12_pair_lanes_wire16']:.1f} ms")
    parent_lanes_wire16_ms(words, g16)

    # GF16 encode_blocks at BASELINE.json:9: 2^14 blocks of 4 KB (k = 2^13),
    # against the generic route; the generic route with the flag on runs
    # its field-domain pair on K11 (GF16 at k = 2^13)
    raw4 = raw[:, :4096].contiguous()
    del raw, words
    with lanes_pair(False):
        want = generic_wire16(raw4)
    blob = routes("lanes_wire16_blocks", lambda: rs.encode_blocks(raw4, GF16),
                  "K12_pair_lanes_wire16", WIRE16)
    check(torch.equal(blob, want), "GF16 encode_blocks (lanes) != the "
          "generic route's bytes")
    with lanes_pair(True):
        gen_on = run_path("lanes_generic16", lambda: generic_wire16(raw4),
                          launches, ("K11_pair_lanes",))
    check(torch.equal(gen_on, want), "the generic route on K11 != on K1-K3")
    say("[lanes_wire16_blocks] encode_blocks 2^13 x 4 KB == the generic "
        "route's bytes, which K11 (GF16, k = 2^13) also gives")
    del raw4, want, blob, gen_on

    # where the narrow tiles start to lose: each route's kernels on 128 MiB
    # at k = 2^10 .. 2^13 (K11: TL = 16, 4, 4, 2; K12: 16, 8, 4, 4), GF32
    # and the GF16 wire pair
    for kk in (1 << 10, 1 << 11, 1 << 12, 1 << 13):
        cols = (1 << 25) // kk
        g, g16 = GF32.root_of_order(2 * kk), GF16.root_of_order(2 * kk)
        x = rand_field(GF32.p, (kk, cols), gen)
        w = torch.randint(-(1 << 31), 1 << 31, (kk, cols), dtype=torch.int32,
                          device="cuda", generator=gen).view(torch.uint32)
        check(torch.equal(m.ntt_pair_lanes(x, GF32, g),
                          m.ntt_pair(x, GF32, pre_seed2=g)),
              f"sweep k={kk}: K11 != K1 -> K2 -> K3")
        with lanes_pair(False):
            check(same(m.ntt_pair_lanes_wire16(w, GF16, g16),
                       m.ntt_coset_pair_wire16(w, GF16, g16)),
                  f"sweep k={kk}: K12 != K8 -> K9 -> K10")
            t = [event_ms(lambda: m.ntt_pair_lanes(x, GF32, g)),
                 event_ms(lambda: m.ntt_pair(x, GF32, pre_seed2=g)),
                 event_ms(lambda: m.ntt_pair_lanes_wire16(w, GF16, g16)),
                 event_ms(lambda: m.ntt_coset_pair_wire16(w, GF16, g16))]
        times[f"lanes_sweep_{kk}"] = t
        say(f"[lanes_sweep] k = {kk} x {cols} (128 MiB): K11 {t[0]:.4f} ms "
            f"against K1 -> K2 -> K3 {t[1]:.4f} ms; K12 {t[2]:.4f} ms "
            f"against K8 -> K9 -> K10 {t[3]:.4f} ms; bit-exact")
    del x, w
    torch.cuda.empty_cache()


def corrupt_rows(cw: torch.Tensor, rows: np.ndarray, p: int, gen,
                 rng: np.random.Generator) -> torch.Tensor:
    """A copy of ``cw`` with the first half of ``rows`` replaced by random
    field values and, in each of the rest, one word of one lane + 1 mod p
    (the sparse corruption the lane combination must catch)."""
    from fastecc_tpu_torch import gf
    bad = cw.clone()
    half = len(rows) // 2
    full = torch.from_numpy(rows[:half]).cuda()
    bad.view(torch.int32)[full] = rand_field(
        p, (half, cw.shape[1]), gen).view(torch.int32)
    for r in rows[half:]:
        word = bad.view(torch.int32)[int(r), int(rng.integers(cw.shape[1]))]
        word.copy_(gf.narrow((gf.widen(word.view(torch.uint32)) + 1) % p)
                   .view(torch.int32))
    return bad


def phase_errors(gen, launches, times):
    from fastecc_tpu_torch import decode, rs, testing
    from fastecc_tpu_torch.fields import GF32
    from fastecc_tpu_torch.utils.timer import median, time_samples

    torch.cuda.reset_peak_memory_stats()
    fix_kernels = ("K5_col_vec", "K6_seam_vec", "K7_row_post_sel")
    rng = np.random.default_rng(0xE770)
    # the full-width GF32 codeword of phase encode: n = 2^20, 1024 lanes
    k, lanes = 1 << 19, 1024
    n = 2 * k
    cw = rs.encode(rand_field(GF32.p, (k, lanes), gen), GF32, n)
    rows = rng.choice(n, size=16, replace=False)
    bad = corrupt_rows(cw, rows, GF32.p, gen, rng)
    want = np.sort(rows)
    pos = run_path("errors_locate", lambda: decode.locate_errors(
        bad, k, GF32, entropy=0xE77), launches, ("K1_col", "K3_row"))
    check(pos is not None and np.array_equal(pos, want),
          f"located {pos} != corrupted {want}")
    fixed, fpos = run_path("errors", lambda: decode.correct_errors(
        bad, k, GF32, entropy=0xE77), launches, ("K1_col", "K3_row")
        + fix_kernels)
    check(np.array_equal(fpos, want) and torch.equal(fixed, cw),
          "correct_errors at full width != the codeword")
    del fixed
    say(f"[errors] 2^20 x {lanes}: 16 corrupted rows (8 replaced, 8 with one "
        f"word + 1) located exactly; correct_errors == the codeword")
    times["locate_s"] = median(time_samples(lambda: decode.locate_errors(
        bad, k, GF32, entropy=0xE77), iters=3, warmup=0))
    times["correct_s"] = median(time_samples(lambda: decode.correct_errors(
        bad, k, GF32, entropy=0xE77), iters=3, warmup=0))
    say(f"[errors] locate_errors median {times['locate_s'] * 1e3:.1f} ms, "
        f"correct_errors median {times['correct_s'] * 1e3:.1f} ms (of 3)")
    profile_once(lambda: decode.correct_errors(bad, k, GF32, entropy=0xE77),
                 "errors")
    del bad

    # errors and erasures: 2^12 known erasures holding garbage, 16 silent
    erased = testing.random_erasures(n, 1 << 12, seed=0xE4)
    rest = np.setdiff1d(np.arange(n), erased)
    rows = rng.choice(rest, size=16, replace=False)
    bad = corrupt_rows(garbage_rows(cw, erased, GF32.p, gen), rows, GF32.p,
                       gen, rng)
    fixed, fpos = run_path("errors_erasures", lambda: decode.correct_errors(
        bad, k, GF32, erased=erased, entropy=0xE78), launches,
        ("K5_col_vec", "K3_row") + fix_kernels)
    check(np.array_equal(fpos, np.sort(rows)) and torch.equal(fixed, cw),
          "correct_errors with erasures != the codeword")
    say("[errors_erasures] e = 2^12 erasures + 16 silent errors at 2^20 x "
        f"{lanes}: the errors located, the codeword recovered")
    del cw, bad, fixed
    torch.cuda.empty_cache()

    # a clean codeword, and corruption beyond (n-k)/2, at n = 2^13
    ks = 1 << 12
    ns = 2 * ks
    cw = rs.encode(rand_field(GF32.p, (ks, lanes), gen), GF32, ns)
    fixed, fpos = decode.correct_errors(cw, ks, GF32, entropy=1)
    check(fpos.size == 0 and torch.equal(fixed, cw), "clean codeword")
    over = rng.choice(ns, size=(ns - ks) // 2 + 8, replace=False)
    try:
        decode.correct_errors(corrupt_rows(cw, over, GF32.p, gen, rng), ks,
                              GF32, entropy=2)
        check(False, "corruption beyond (n-k)/2 did not raise")
    except ValueError as e:
        say(f"[errors] n = 2^13: clean codeword -> no positions; "
            f"{len(over)} corrupted rows > (n-k)/2 -> ValueError ({e})")
    del cw, fixed

    # decode_blocks(check=True) at BASELINE.json:10: k + 64 of 2^13 4 KB
    # blocks survive, 16 of them (8 data, 8 parity) silently changed
    block = 4096
    raw = torch.randint(0, 256, (ks, block), dtype=torch.uint8,
                        device="cuda", generator=gen)
    parity = rs.encode_blocks(raw, GF32)
    raw_np, par_np = raw.cpu().numpy(), parity.cpu().numpy()
    keep = rng.choice(ns, size=ks + 64, replace=False)
    dpos = set(rs.data_positions(ns, ks).tolist())
    ppos = {int(q): i for i, q in enumerate(rs.parity_positions(ns, ks))}
    surv = {int(q): bytearray(raw_np[q // 2] if q in dpos
                              else par_np[ppos[q]]) for q in keep}
    kept_d = [q for q in surv if q in dpos]
    kept_p = [q for q in surv if q not in dpos]
    for q in list(rng.choice(kept_d, 8, replace=False)) + list(
            rng.choice(kept_p, 8, replace=False)):
        blob = surv[int(q)]
        # a stored word below 0xFF000000 changes by 256 and stays < p
        j = next(j for j in rng.permutation(block // 4)
                 if blob[4 * j + 3] != 0xFF)
        blob[4 * j + 1] ^= 0x01
    surv = {q: bytes(b) for q, b in surv.items()}
    got = run_path("errors_blocks", lambda: decode.decode_blocks(
        surv, ns, ks, GF32, block_bytes=block, check=True), launches,
        fix_kernels)
    check(torch.equal(got, raw), "decode_blocks(check=True) != the raw data")
    unchecked = decode.decode_blocks(surv, ns, ks, GF32, block_bytes=block)
    check(not torch.equal(unchecked, raw),
          "decode_blocks(check=False) recovered lying survivors")
    times["errors_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    say(f"[errors_blocks] {ks + 64} survivors of {ns}, 16 lying (8 data, 8 "
        f"parity): check=True == the raw data, check=False does not; the "
        f"phase's peak device memory {times['errors_mem_gib']:.2f} GiB")
    del raw, parity, got, unchecked
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase storage: the file layer (storage, host, the CLI's file commands).
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent
BLOCK = 4096
MAX_RESIDENT = 256 << 20          # what `--max-resident 256` gives
# The run's time limit forces a cut of depth (block counts; never the 4 KB
# block or the field): the phase is file-bound, at 0.26-0.42 ms a block
# file written or read on the card's machine (measured on one H100's host:
# 137.8 s to emit a 1 GiB file's 2^19 block files), so the full sizes (a 1 GiB
# GF32 file, GF16 at its capacity of 2^15 blocks, stripes of 2^16 blocks,
# a 64 MiB file for the CLI) take ~4 M block-file operations, ~25 min.
# Each depth is halved this many times.
STORAGE_DEPTH_CUT = 3


def random_file(path: Path, size: int, gen) -> None:
    """``size`` random bytes from the seeded card generator."""
    with open(path, "wb") as fh:
        left = size
        while left:
            m = min(left, 256 << 20)
            fh.write(torch.randint(0, 256, (m,), dtype=torch.uint8,
                                   device="cuda", generator=gen)
                     .cpu().numpy().tobytes())
            left -= m


def sha_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while chunk := fh.read(64 << 20):
            h.update(chunk)
    return h.hexdigest()


def tree_bytes(d: Path) -> int:
    return sum(p.stat().st_size for p in d.rglob("*") if p.is_file())


def parity_sha(d: Path, n: int, k: int) -> str:
    """SHA-256 over every parity file's bytes, in encode_parity row order."""
    from fastecc_tpu_torch import rs
    h = hashlib.sha256()
    for q in rs.parity_positions(n, k):
        h.update((d / f"block_{int(q):06d}.par").read_bytes())
    return h.hexdigest()


def encode_blocks_sha(src: Path, k: int, field) -> str:
    """SHA-256 of rs.encode_blocks over the whole file in device memory
    (the zero-padded [k, 4096] blocks)."""
    from fastecc_tpu_torch import rs
    raw = np.zeros(k * BLOCK, np.uint8)
    data = np.fromfile(src, np.uint8)
    raw[:data.size] = data
    par = rs.encode_blocks(torch.from_numpy(raw.reshape(k, BLOCK)).cuda(),
                           field).cpu().numpy()
    return hashlib.sha256(par).hexdigest()


def lose(d: Path, count: int, rng) -> list:
    """Delete ``count`` random block files of one codeword directory."""
    files = sorted(d.glob("block_*.dat")) + sorted(d.glob("block_*.par"))
    gone = [files[i] for i in rng.choice(len(files), count, replace=False)]
    for f in gone:
        f.unlink()
    return gone


@contextlib.contextmanager
def timed_calls(mod, names, acc: dict):
    """Sum the wall seconds of each named function of ``mod`` into
    ``acc`` while the context is open (the functions stay the same)."""
    real = {nm: getattr(mod, nm) for nm in names}

    def wrap(nm):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real[nm](*a, **kw)
            finally:
                acc[nm] = acc.get(nm, 0.0) + time.perf_counter() - t0
        return timed
    for nm in names:
        setattr(mod, nm, wrap(nm))
    try:
        yield acc
    finally:
        for nm, fn in real.items():
            setattr(mod, nm, fn)


def storage_run(name: str, fn, launches, expect, file_bytes: int,
                written, times) -> tuple:
    """One storage operation through run_path (counts reset before, read
    after; each kernel in ``expect`` must launch), timed on the host
    clock; prints its wall, its rate in MB/s of file bytes and the bytes
    it wrote to disk (``written()`` after the run)."""
    t0 = time.perf_counter()
    out = run_path(name, fn, launches, expect)
    wall = time.perf_counter() - t0
    wrote = written()
    times["storage"][name] = wall
    say(f"[storage] {name}: {wall:.3f} s, {file_bytes / wall / 1e6:.1f} "
        f"MB/s of {file_bytes} file bytes, wrote {wrote} B to disk")
    return out, wall


def storage_sizes(free: int) -> tuple[dict, list]:
    """The phase's depths after the time limit's cut (STORAGE_DEPTH_CUT)
    and the disk's (the GF32 section holds the source, the 2x directory,
    the [n, lanes] codeword stage and the recovered file at once, ~6.2x
    the file: halve it until 6.5x fits 80% of the free space), with a
    line per cut."""
    full = {"gf32_bytes": 1 << 30, "gf16_k": 1 << 15,
            "stripe_blocks": 1 << 16, "cli_bytes": 64 << 20}
    sizes = {k: v >> STORAGE_DEPTH_CUT for k, v in full.items()}
    cuts = [f"{k} {full[k]} -> {sizes[k]} (time limit)" for k in full
            if sizes[k] != full[k]]
    while 6.5 * sizes["gf32_bytes"] > 0.8 * free:
        sizes["gf32_bytes"] //= 2
        cuts.append(f"gf32_bytes -> {sizes['gf32_bytes']} (disk: "
                    f"{free >> 20} MiB free)")
    return sizes, cuts


def file_op_us(work: Path, count: int = 2048) -> tuple[float, float]:
    """Microseconds to write and to read one 4 KB block file here (the
    unit of the phase's cost)."""
    blob = bytes(BLOCK)
    t0 = time.perf_counter()
    for i in range(count):
        (work / f"probe_{i:06d}.dat").write_bytes(blob)
    t1 = time.perf_counter()
    for i in range(count):
        (work / f"probe_{i:06d}.dat").read_bytes()
    t2 = time.perf_counter()
    for i in range(count):
        (work / f"probe_{i:06d}.dat").unlink()
    return (t1 - t0) / count * 1e6, (t2 - t1) / count * 1e6


def phase_storage(gen, launches, times) -> None:
    import shutil
    import tempfile

    from fastecc_tpu_torch import host, rs, storage
    from fastecc_tpu_torch.fields import GF16, GF32

    check(host.build(), "the native host library builds")
    check(host.available(), "the native host library is loaded")
    say(f"[storage] native host library {host._target().name}")
    enc_kernels = ("K1_col", "K2_seam", "K3_row")
    rec_kernels = ("K5_col_vec", "K6_seam_vec", "K7_row_post_sel")
    times["storage"] = {}
    rng = np.random.default_rng(0x5707)
    work = Path(tempfile.mkdtemp(prefix="fastecc_storage_"))
    try:
        w_us, r_us = file_op_us(work)
        sizes, cuts = storage_sizes(shutil.disk_usage(work).free)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"[storage] work under {work.parent}: a 4 KB block file takes "
        f"{w_us:.1f} us to write and {r_us:.1f} us to read; cuts: "
        f"{'; '.join(cuts) or 'none'}")
    times["storage"]["file_write_us"] = w_us
    times["storage"]["file_read_us"] = r_us

    # GF32, one codeword: 1 GiB of 4 KB blocks (k = 2^18, n = 2^19) uncut
    work = Path(tempfile.mkdtemp(prefix="fastecc_storage_"))
    try:
        size = sizes["gf32_bytes"]
        src, d, back = work / "gf32.bin", work / "coded", work / "back.bin"
        random_file(src, size, gen)
        want = sha_file(src)
        k = size // BLOCK
        n = 2 * k
        cw = storage._plan_word_chunk(GF32, k, BLOCK // 4, MAX_RESIDENT)
        parts = {}
        with timed_calls(storage, ("_encode_stage", "_emit_encoded"), parts):
            man, _ = storage_run(
                "storage_encode", lambda: storage.encode_file(
                    src, d, GF32, max_resident_bytes=MAX_RESIDENT),
                launches, enc_kernels, size, lambda: tree_bytes(d), times)
        check(man["k"] == k and man["n"] == n, "GF32 manifest k, n")
        times["storage"]["encode_stage"] = parts["_encode_stage"]
        times["storage"]["encode_emit"] = parts["_emit_encoded"]
        say(f"[storage] storage_encode: k = {k}, {BLOCK // 4 // cw} word "
            f"chunks of {cw}; device stage (_encode_stage) "
            f"{parts['_encode_stage']:.3f} s, host emission (_emit_encoded) "
            f"{parts['_emit_encoded']:.3f} s")
        check(parity_sha(d, n, k) == encode_blocks_sha(src, k, GF32),
              "streamed GF32 parity != rs.encode_blocks of the whole file")
        say("[storage] SHA-256 of every .par file == rs.encode_blocks of the "
            "whole file in device memory")
        lose(d, n - k, rng)
        storage_run("storage_recover", lambda: storage.recover_file(
            d, back, max_resident_bytes=MAX_RESIDENT), launches,
            rec_kernels, size, lambda: back.stat().st_size, times)
        check(sha_file(back) == want, "GF32 recover != the source")
        back.unlink()
        say(f"[storage] {n - k} of {n} block files lost: the recovered "
            f"file's SHA-256 == the source's")
        wrote0 = tree_bytes(d)
        storage_run("storage_repair_lost", lambda: storage.recover_file(
            d, None, max_resident_bytes=MAX_RESIDENT, repair=True),
            launches, rec_kernels, size,
            lambda: tree_bytes(d) - wrote0, times)
        check(len(list(d.glob("block_*"))) == n, "repair rewrote every file")

        # audit and repair: 16 blocks (8 data, 8 parity) changed with
        # their manifest CRCs forged
        man = json.loads((d / "manifest.json").read_text())
        dpos = rs.data_positions(n, k)
        ppos = rs.parity_positions(n, k)
        bad = sorted([int(q) for q in rng.choice(dpos, 8, replace=False)] +
                     [int(q) for q in rng.choice(ppos, 8, replace=False)])
        good = {}
        for q in bad:
            data = q % 2 == 0            # rate 1/2: data at even positions
            f = d / f"block_{q:06d}.{'dat' if data else 'par'}"
            blob = bytearray(f.read_bytes())
            good[f] = bytes(blob)
            if data:
                blob[:] = rng.integers(0, 256, len(blob),
                                       dtype=np.uint8).tobytes()
            else:
                # a stored word below 0xFF000000 changes by 256, < p
                j = next(j for j in rng.permutation(len(blob) // 4)
                         if blob[4 * j + 3] != 0xFF)
                blob[4 * j + 1] ^= 0x01
            f.write_bytes(bytes(blob))
            man["crc32c"][str(q)] = host.crc32c(bytes(blob))
        (d / "manifest.json").write_text(json.dumps(man))
        (report, rc), _ = storage_run(
            "storage_check", lambda: storage.check_file(
                d, max_resident_bytes=MAX_RESIDENT), launches,
            ("K1_col", "K3_row"), size, lambda: 0, times)
        check(rc == 1 and report["status"] == "corrupt-located"
              and report["located_corrupt"] == bad,
              f"check located {report['located_corrupt']} != {bad}")
        wrote = storage_run("storage_repair_located",
                            lambda: storage.recover_file(
                                d, None, max_resident_bytes=MAX_RESIDENT,
                                repair=True, check=True), launches,
                            ("K1_col", "K3_row") + rec_kernels, size,
                            lambda: sum(map(len, good.values())), times)[0]
        check(wrote == 16 and all(f.read_bytes() == b
                                  for f, b in good.items()),
              "repair did not restore the 16 changed blocks")
        (report, rc), _ = storage_run(
            "storage_check_clean", lambda: storage.check_file(
                d, max_resident_bytes=MAX_RESIDENT), launches,
            ("K1_col", "K3_row"), size, lambda: 0, times)
        check(rc == 0 and report["status"] == "healthy",
              "check after repair is not clean")
        say("[storage] 16 blocks changed under forged CRCs: check located "
            "all 16, repair restored them and re-tagged, check reads clean")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # GF16 at its capacity, k = 2^15 blocks of 4 KB (128 MiB), uncut
    work = Path(tempfile.mkdtemp(prefix="fastecc_storage_"))
    try:
        k = sizes["gf16_k"]
        check(k <= storage.stripe_capacity_blocks(GF16), "GF16 capacity")
        n, size16 = 2 * k, k * BLOCK
        src, d, back = work / "gf16.bin", work / "coded", work / "back.bin"
        random_file(src, size16, gen)
        storage_run("storage_encode_gf16", lambda: storage.encode_file(
            src, d, GF16, max_resident_bytes=MAX_RESIDENT), launches,
            enc_kernels, size16, lambda: tree_bytes(d), times)
        check(parity_sha(d, n, k) == encode_blocks_sha(src, k, GF16),
              "GF16 parity != rs.encode_blocks (the wire pair)")
        d2 = work / "profiled"
        times["storage"]["busy_share"] = profile_once(
            lambda: storage.encode_file_stream(
                src, d2, GF16, max_resident_bytes=MAX_RESIDENT),
            "storage_encode_file_stream", warmup=False)
        shutil.rmtree(d2)
        lose(d, n - k, rng)
        storage_run("storage_recover_gf16", lambda: storage.recover_file(
            d, back, max_resident_bytes=MAX_RESIDENT), launches,
            rec_kernels, size16, lambda: back.stat().st_size, times)
        check(sha_file(back) == sha_file(src), "GF16 recover != the source")
        say(f"[storage] GF16 k = {k}: parity == rs.encode_blocks (the wire "
            f"pair), {n - k} files lost and the source recovered")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # striped: GF32, 2 x 2^16 + 1 blocks in stripes of 2^16 uncut, the
    # last of one (partial) block
    work = Path(tempfile.mkdtemp(prefix="fastecc_storage_"))
    try:
        sb = sizes["stripe_blocks"]
        size_s = 2 * sb * BLOCK + 1
        src, d, back = work / "striped.bin", work / "coded", work / "back.bin"
        random_file(src, size_s, gen)
        man, _ = storage_run("storage_encode_striped", lambda:
                             storage.encode_file(
                                 src, d, GF32, stripe_blocks=sb,
                                 max_resident_bytes=MAX_RESIDENT),
                             launches, enc_kernels, size_s,
                             lambda: tree_bytes(d), times)
        check([st["k"] for st in man["stripes"]] == [sb, sb, 1],
              f"stripes {[st['k'] for st in man['stripes']]}")
        # stripe 1 at its largest loss, its first data block among them
        s1 = d / "stripe_0001"
        (s1 / "block_000000.dat").unlink()
        lose(s1, sb - 1, rng)
        storage_run("storage_recover_striped", lambda: storage.recover_file(
            d, back, max_resident_bytes=MAX_RESIDENT), launches,
            rec_kernels, size_s, lambda: back.stat().st_size, times)
        check(sha_file(back) == sha_file(src), "striped recover != source")
        payload = bytearray(src.read_bytes())
        off = sb * BLOCK - 1000                  # across the stripe seam
        got = storage_run("storage_read_seam", lambda: storage.read_file(
            d, off, 5000), launches, rec_kernels, 5000, lambda: 0,
            times)[0]
        check(got == bytes(payload[off:off + 5000]),
              "degraded read across the stripe seam")
        edit = rng.integers(0, 256, 3 * BLOCK, dtype=np.uint8).tobytes()
        eoff = 10 * BLOCK
        nblk = storage_run("storage_update", lambda: storage.update_file(
            d, eoff, edit), launches, (), len(edit),
            lambda: 3 * BLOCK, times)[0]
        check(nblk == 3, f"update rewrote {nblk} blocks")
        payload[eoff:eoff + len(edit)] = edit
        storage_run("storage_recover_updated", lambda: storage.recover_file(
            d, back, max_resident_bytes=MAX_RESIDENT), launches,
            rec_kernels, size_s, lambda: back.stat().st_size, times)
        check(back.read_bytes() == bytes(payload),
              "recover after update != the updated file")
        say(f"[storage] striped {size_s} B: stripes k = [{sb}, {sb}, 1]; "
            f"stripe 1 at its largest loss recovered; a 5000-byte read across the "
            f"seam; 3 blocks updated and the updated file recovered")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # the CLI on the card: encode, recover, check as subprocesses on a
    # 64 MiB file uncut
    work = Path(tempfile.mkdtemp(prefix="fastecc_storage_"))
    try:
        sizec = sizes["cli_bytes"]
        src, d, back = work / "cli.bin", work / "coded", work / "back.bin"
        random_file(src, sizec, gen)

        def cli(*argv):
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, "-m", "fastecc_tpu_torch.cli",
                                *map(str, argv)], cwd=REPO,
                               capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            times["storage"]["cli_" + argv[0]] = wall
            say(f"[storage] cli {argv[0]}: rc {p.returncode}, {wall:.3f} s, "
                f"{sizec / wall / 1e6:.1f} MB/s: "
                f"{(p.stdout.strip().splitlines() or [''])[-1][:160]}")
            return p
        p = cli("encode", src, "-o", d)
        check(p.returncode == 0, f"cli encode: {p.stderr[-2000:]}")
        man = json.loads((d / "manifest.json").read_text())
        lose(d, man["n"] - man["k"], rng)
        p = cli("recover", d, "-o", back)
        check(p.returncode == 0, f"cli recover: {p.stderr[-2000:]}")
        check(sha_file(back) == sha_file(src), "cli recover != the source")
        p = cli("check", d)
        rep = json.loads(p.stdout.strip().splitlines()[-1])
        check(p.returncode == 1 and rep["status"] == "degraded"
              and rep["device"] == torch.cuda.get_device_name(0),
              f"cli check: rc {p.returncode} {rep.get('status')}")
        say("[storage] cli encode -> recover (half the files lost) -> check "
            "on the card: the recovered file == the source, check rc 1 "
            "(degraded)")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# The parallel phase: worlds of ranks sharing the card over Gloo (NCCL
# refuses two ranks of one communicator on one GPU), each mesh with the
# halvings of depth (k and n) its shapes take for the time limit, and the
# one-rank NCCL world (the passthrough).
PARALLEL_WORLDS = (((2, 1), 0), ((4, 1), 1), ((2, 2), 1), ((1, 1), 0))
PARALLEL_SEED = 0x9A5A11E1
# exchanges a call makes with a coeff axis (3 a transform, 2 at each
# transposed end, 4 for a pair, 3 a chunk in the overlapped form)
PARALLEL_COLLECTIVES = {"enc32": 4, "enc16": 4, "ntt": 3, "intt": 3,
                        "ov2": 6, "out_t": 2, "in_t": 2, "dec": 4}


def parallel_shapes(cut: int) -> dict:
    """name -> (op, field, rows, lanes) at ``cut`` halvings of depth:
    the GF32 encode at BASELINE.json:11's k = 2^19 (n = 2^20) x 1024, the
    GF16 encode at its largest order (k = 2^15) x 1024, the NTT family at
    2^20 x 512, the decode at n = 2^20, e = 2^19, 512 lanes."""
    return {"enc32": ("encode", "GF32", 1 << (19 - cut), 1024),
            "enc16": ("encode", "GF16", 1 << (15 - cut), 1024),
            "ntt": ("ntt", "GF32", 1 << (20 - cut), 512),
            "intt": ("ntt", "GF32", 1 << (20 - cut), 512),
            "ov2": ("ntt_overlap", "GF32", 1 << (20 - cut), 512),
            "out_t": ("ntt", "GF32", 1 << (20 - cut), 512),
            "in_t": ("ntt", "GF32", 1 << (20 - cut), 512),
            "dec": ("decode", "GF32", 1 << (20 - cut), 512)}


def _inner(n: int) -> int:
    """C of the transposed layouts ([R, C, L]) at n points, D <= 4."""
    return 1 << ((n.bit_length() - 1) // 2)


def shard_digests(ref: torch.Tensor, meshes, transposed_c: int = 0
                  ) -> dict:
    """mesh -> every rank's SHA-256 of its slice of the single-card
    ``ref`` ([N, L]; with ``transposed_c`` viewed [N/C, C, L] and sliced
    on the middle axis), the same bytes parallel._worker.digest hashes:
    one copy to the host, the slices hashed in threads."""
    from concurrent.futures import ThreadPoolExecutor

    v = ref.view(torch.int32).cpu().numpy()
    if transposed_c:
        v = v.reshape(v.shape[0] // transposed_c, transposed_c, -1)
    ax = 1 if transposed_c else 0
    jobs = []
    for dc, db in meshes:
        rows, lanes = v.shape[ax] // dc, v.shape[-1] // db
        for r in range(dc * db):
            ci, bi = divmod(r, db)
            sl = [slice(None)] * v.ndim
            sl[ax] = slice(ci * rows, (ci + 1) * rows)
            sl[-1] = slice(bi * lanes, (bi + 1) * lanes)
            jobs.append(((dc, db), v[tuple(sl)]))

    def sha(part):
        return hashlib.sha256(np.ascontiguousarray(part).data).hexdigest()
    with ThreadPoolExecutor(8) as pool:
        shas = list(pool.map(lambda j: sha(j[1]), jobs))
    out = {}
    for (m, _), sha in zip(jobs, shas):
        out.setdefault(m, []).append(sha)
    return out


def parallel_refs(cut: int, meshes) -> dict:
    """name -> mesh -> each rank's expected digest: the single-card port
    (rs.encode_parity, ntt.ntt_auto, decode.decode_prepared) on the card,
    on the inputs the ranks draw (parallel._worker.seeded_u32 and
    garbled_codeword from the same seeds)."""
    from fastecc_tpu_torch import decode, ntt, rs
    from fastecc_tpu_torch.fields import GF16, GF32
    from fastecc_tpu_torch.parallel._worker import (garbled_codeword,
                                                    seeded_u32)
    sh = parallel_shapes(cut)
    refs = {}
    for name, field, seed in (("enc32", GF32, 1), ("enc16", GF16, 2)):
        _, _, k, lanes = sh[name]
        data = seeded_u32(field.p, (k, lanes), PARALLEL_SEED + seed, "cuda")
        refs[name] = shard_digests(rs.encode_parity(data, field, 2 * k),
                                   meshes)
        del data
    _, _, n, lanes = sh["ntt"]
    x = seeded_u32(GF32.p, (n, lanes), PARALLEL_SEED + 3, "cuda")
    fwd = ntt.ntt_auto(x, GF32)
    refs["ntt"] = refs["ov2"] = refs["in_t"] = shard_digests(fwd, meshes)
    del fwd
    inv = ntt.ntt_auto(x, GF32, inverse=True)
    refs["intt"] = shard_digests(inv, meshes)
    refs["out_t"] = shard_digests(inv, meshes, transposed_c=_inner(n))
    del x, inv
    _, _, n, lanes = sh["dec"]
    cw, bad, erased = garbled_codeword(GF32, n // 2, lanes,
                                       PARALLEL_SEED + 4, n // 2, "cuda")
    out = decode.decode_prepared(bad, *decode.prepare_decode_tables(
        erased, n, GF32, device=bad.device), GF32)
    check(torch.equal(out, cw), "the single-card decode != the codeword")
    refs["dec"] = shard_digests(cw, meshes)
    del cw, bad, out
    torch.cuda.synchronize()
    return refs


def parallel_cases(cut: int, refs: dict, m) -> list:
    """The phase's cases for a world of mesh ``m`` (see
    fastecc_tpu_torch/parallel/_worker.py), each rank held to its
    digest; the median of 3 timed calls after the first."""
    sh = parallel_shapes(cut)
    s = PARALLEL_SEED
    n = sh["ntt"][2]
    x = {"seeded": [n, sh["ntt"][3]], "seed": s + 3}
    inputs = {
        "enc32": {"seeded": [sh["enc32"][2], 1024], "seed": s + 1},
        "enc16": {"seeded": [sh["enc16"][2], 1024], "seed": s + 2},
        "ntt": x, "intt": x, "ov2": x, "out_t": x,
        "in_t": dict(x, view=n // _inner(n)),
        "dec": {"codeword": [sh["dec"][2] // 2, sh["dec"][3]],
                "seed": s + 4, "e": sh["dec"][2] // 2}}
    args = {"enc32": {"n": 2 * sh["enc32"][2]},
            "enc16": {"n": 2 * sh["enc16"][2]},
            "intt": {"inverse": True}, "ov2": {"chunks": 2},
            "out_t": {"inverse": True, "output_transposed": True},
            "in_t": {"input_transposed": True}}
    cases = []
    for name, (op, field, _, _) in sh.items():
        cases.append({"name": name, "op": op, "field": field,
                      "input": inputs[name], "args": args.get(name, {}),
                      "iters": 0 if name in ("out_t", "in_t") else 3,
                      "expect_sha": refs[name][m],
                      "profile": name == "enc32" and m == (2, 1)})
    return cases


def parallel_cli() -> None:
    """The CLI's scaling on the card: the weak-scaling sweep of the GF32
    encode (worlds of 1, 2 and 4 ranks, 256 lanes a rank, k = 2^19) and
    the --procs 4 structural row with --update-baseline into a temporary
    file; each row parsed and checked."""
    import tempfile

    def cli(*argv):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "fastecc_tpu_torch.cli",
                            "scaling", *argv], cwd=REPO, capture_output=True,
                           text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(p.returncode == 0, f"cli scaling {argv}: rc {p.returncode} "
              f"{p.stderr[-3000:]}")
        rows = [json.loads(ln) for ln in p.stdout.splitlines()
                if ln.startswith("{")]
        for r in rows:
            say(f"[parallel] cli scaling {' '.join(argv[:2])}: "
                f"{json.dumps(r)}")
        say(f"[parallel] cli scaling {' '.join(argv)}: {wall:.1f} s")
        return rows
    rows = cli("--op", "encode", "--devices", "4", "--lg-k", "19",
               "--lanes", "256", "--iters", "2")
    check([r["devices"] for r in rows] == [1, 2, 4]
          and [r["lanes"] for r in rows] == [256, 512, 1024],
          "cli scaling: the sweep's worlds")
    check([r["backend"] for r in rows] == ["nccl", "gloo", "gloo"]
          and [r["virtual"] for r in rows] == [False, True, True]
          and all(r["gb_per_sec"] > 0 for r in rows),
          "cli scaling: backends, virtual tags and rates")
    with tempfile.TemporaryDirectory(prefix="fastecc_baseline_") as td:
        path = Path(td) / "BASELINE.md"
        (row,) = cli("--procs", "4", "--update-baseline",
                     "--baseline-path", str(path))
        lines = path.read_text().splitlines()
        check(sorted(p.name for p in Path(td).iterdir()) == ["BASELINE.md"]
              and lines[-1].startswith("- ") and "4-process 2x2 gloo" in
              lines[-1], "cli scaling --update-baseline: one line appended "
              "to the given path")
    check(row["bit_exact"] is True and row["all_to_all"] == {
        "ntt": 3, "encode": 4, "decode": 4} and row["transport"] == "gloo"
        and row["virtual"] is True and row["mesh"] == "2x2",
        f"cli scaling --procs 4: {row}")


def phase_parallel(launches, times) -> None:
    """The sharded codec (fastecc_tpu_torch.parallel) on worlds of ranks
    sharing the card, each rank's shard held to the single-card port's
    digest; then the CLI's scaling."""
    from fastecc_tpu_torch.parallel import _worker
    from fastecc_tpu_torch.utils.timer import median

    free, total = torch.cuda.mem_get_info()
    cuts = {m: c for m, c in PARALLEL_WORLDS}
    say(f"[parallel] worlds {[f'{m[0]}x{m[1]}' for m in cuts]} on one "
        f"card; depth cuts (halvings of k and n, time limit) "
        f"{ {f'{m[0]}x{m[1]}': c for m, c in cuts.items()} }; "
        f"device memory free {free / 2**30:.1f} of {total / 2**30:.1f} GiB")
    t_refs = time.perf_counter()
    refs = {c: parallel_refs(c, [m for m, mc in cuts.items() if mc == c])
            for c in sorted(set(cuts.values()))}
    say(f"[parallel] single-card references and digests: "
        f"{time.perf_counter() - t_refs:.1f} s")
    launches["parallel"] = {k: 0 for k in REPLACES}
    times["parallel"] = {}
    for m, cut in PARALLEL_WORLDS:
        torch.cuda.empty_cache()
        world = m[0] * m[1]
        t0 = time.perf_counter()
        reps = _worker.launch({"mesh": m, "device": "cuda",
                               "cases": parallel_cases(cut, refs[cut], m)},
                              world, timeout=600)
        wall = time.perf_counter() - t0
        tag = f"{m[0]}x{m[1]}"
        backend = reps[0]["backend"]
        check(backend == ("nccl" if world == 1 else "gloo"),
              f"{tag}: backend {backend}")
        parts, world_launches = [], {}
        for name in parallel_shapes(cut):
            for r, rep in enumerate(reps):
                case = rep["cases"][name]
                check(case["sha_match"], f"{tag} {name}: rank {r}'s shard "
                      f"!= the single-card port's")
                want = PARALLEL_COLLECTIVES[name] if m[0] > 1 else 0
                check(case["collectives"]["all_to_all"] == want,
                      f"{tag} {name}: {case['collectives']} exchanges, "
                      f"want {want}")
                for k, v in case["launches"].items():
                    launches["parallel"][k] += v
                    world_launches[k] = world_launches.get(k, 0) + v
            c0 = reps[0]["cases"][name]
            if c0["samples"]:
                ms = median(c0["samples"]) * 1e3
                times["parallel"][f"{tag}_{name}_ms"] = ms
                parts.append(f"{name} {ms:.3f} ms")
            else:
                parts.append(f"{name} (one call)")
        mb = reps[0]["cases"]["enc32"]["collectives"]["all_to_all_bytes"]
        say(f"[parallel] {tag} ({backend}, {world} rank(s), cut {cut}): "
            f"every rank's shard == the single-card port's digest; medians "
            f"of 3 (rank 0, barriers around each call): {', '.join(parts)}; "
            f"enc32 exchanges {mb / 2**20:.0f} MiB a rank a call; launches "
            f"(all ranks, one call of each) {world_launches}; rank 0 "
            f"began with {reps[0]['mem_free_total'][0] / 2**30:.1f} GiB "
            f"free; world wall {wall:.1f} s")
        say(f"[parallel] {tag} case walls (rank 0: input, calls, hash) "
            + ", ".join(f"{k} {v['case_s']:.1f} s"
                        for k, v in reps[0]["cases"].items()))
        prof = reps[0]["cases"]["enc32"].get("profile")
        if prof:
            say(f"[parallel] {tag} enc32 rank 0 profile: {json.dumps(prof)}")
    for k in ("K1_col", "K3_row"):
        check(launches["parallel"][k] > 0,
              f"parallel: the ranks did not launch {k}")
    say(f"[parallel] launches "
        f"{ {k: v for k, v in launches['parallel'].items() if v} }")
    parallel_cli()


def phase_peaks(gen, launches, times, shapes, worst):
    from fastecc_tpu_torch.fields import FIELDS, GF32
    from fastecc_tpu_torch.kernels import microbench as mb
    from fastecc_tpu_torch.utils import profiling

    def cmp(name, got, want, what):
        compare(worst, name, got, want, what)

    # K13 at ragged sizes, and from a pointer that is not 16-byte aligned
    words = torch.randint(-(1 << 31), 1 << 31, ((1 << 20) + 3,),
                          dtype=torch.int32, device="cuda",
                          generator=gen).view(torch.uint32)
    # (around multiples of a block's span: 1024 words, 256 on the unaligned
    # path)
    for n in (1, 5, 1023, 1025, 1026, 1027, 3 * 1024 + 1, (1 << 20) + 3):
        cmp("K13_copy", mb.copy(words[:n]), words[:n].clone(), n)
    for n in (255, 257, 3 * 256 + 1):
        cmp("K13_copy", mb.copy(words[1:n + 1]), words[1:n + 1].clone(),
            ("unaligned", n))
    cmp("K13_copy", mb.copy(words[1:]), words[1:].clone(), "unaligned")
    # K14, every variant, at depth 3 and at its default depth; the Solinas
    # family also on the edge operands (mb.solinas_edge_pairs)
    x, z = mb.chain_inputs(4 * mb._TS, "cuda")
    for v in mb._VARIANTS:
        deep = mb._COMPOSITE_DEPTH if v in mb._COMPOSITE else mb._DEFAULT_DEPTH
        for depth in (3, deep):
            cmp("K14_chain", mb.chain(x, z, v, depth),
                mb.chain_plain(x, z, v, depth), (v, depth))
    ex, ez = mb.solinas_edge_inputs("cuda")
    for v in ("solinas", "solinas-bcast", "solinas-masksel"):
        for depth in (1, 3, mb._DEFAULT_DEPTH):
            cmp("K14_chain", mb.chain(ex, ez, v, depth),
                mb.chain_plain(ex, ez, v, depth), (v, "edge", depth))
    # K15 on the three fused configs, and at every c in both fields over
    # 13 and 40 lanes (zero-filled past L), at depths 0-3
    for key, cfg in mb._FUSED_CONFIGS.items():
        field = FIELDS[cfg["field_name"]]
        for rows_tiles in (1, 2):
            xf = mb.fused_inputs(field, cfg["c"], rows_tiles, "cuda")
            for depth in range(4):
                cmp("K15_fused_chain", mb.fused_chain(xf, field, depth),
                    mb.fused_chain_plain(xf, field, depth),
                    (key, rows_tiles, depth))
    g15 = torch.Generator(device="cuda").manual_seed(0xF15)
    for field in FIELDS.values():
        for la in range(1, 12):
            for lanes in (13, 40):
                y = rand_field(field.p, (1 << la, lanes), g15)
                for depth in range(4):
                    cmp("K15_fused_chain", mb.fused_chain(y, field, depth),
                        mb.fused_chain_plain(y, field, depth),
                        (field.name, 1 << la, lanes, depth))
    say(f"[peaks] K13 (ragged, unaligned), K14 ({len(mb._VARIANTS)} "
        f"variants at depth 3 and their default; the Solinas family on "
        f"{len(mb.solinas_edge_pairs()[0])} edge pairs at depths 1, 3, "
        f"128), K15 (3 configs, 1-2 row tiles; every c = 2 .. 2048 in both "
        f"fields over 13 and 40 lanes; depths 0-3) == plain")
    del words, x, z, ex, ez, xf, y

    # the main path: the reference's measure_peaks at its full sizes
    peaks = run_path("peaks", mb.measure_peaks, launches, PEAKS)
    want = ({"hbm_stream_gbps"} | {mb.peak_key(v) for v in mb._VARIANTS}
            | set(mb._FUSED_CONFIGS))
    check(set(peaks) == want, f"measure_peaks keys {sorted(peaks)}")
    check(all(np.isfinite(v) and v > 0 for v in peaks.values()),
          "every peak is a positive rate")
    line = json.dumps({"peaks": peaks}, separators=(",", ":"))
    check(len(line) < 1500, f"peaks line is {len(line)} characters")
    say(line)
    times["peaks"] = peaks

    # Each kernel again at the main path's shapes, against its plain
    # version, then timed there for its row. K13 on the 256 MiB and 1 GiB
    # copies (a grid over the whole array), beside torch's copy_ and, where
    # build/parent holds an earlier checkout, its K13
    for mib in (256, 1024):
        src = torch.arange(mib << 18, dtype=torch.int32,
                           device="cuda").view(torch.uint32)
        dst = torch.empty_like(src)
        cmp("K13_copy", mb.copy(src), src, f"{mib} MiB")
        k13 = event_ms(lambda: mb.copy(src))
        lib = event_ms(lambda: dst.copy_(src))
        say(f"[peaks] {mib} MiB copy: K13 {k13:.4f} ms "
            f"({2 * src.numel() * 4 / k13 / 1e6:.1f} GB/s), copy_ "
            f"{lib:.4f} ms ({2 * src.numel() * 4 / lib / 1e6:.1f} GB/s)")
        parent_copy_ms(src, dst)
    times["K13_copy"], times["library_K13_copy"] = k13, lib
    times["plain_K13_copy"] = event_ms(lambda: src.clone())
    shapes["K13_copy"] = (src.numel(),)
    del src, dst
    # K14: every variant on the 64 MiB [131072, 128] at its default depth;
    # the row is the solinas chain at depth 128
    rows = 64 * 1024 * 1024 // (4 * mb._TL)
    x, z = mb.chain_inputs(rows, "cuda")
    for v in mb._VARIANTS:
        deep = mb._COMPOSITE_DEPTH if v in mb._COMPOSITE else mb._DEFAULT_DEPTH
        cmp("K14_chain", mb.chain(x, z, v, deep),
            mb.chain_plain(x, z, v, deep), (v, "64 MiB", deep))
    times["K14_chain"] = event_ms(lambda: mb.chain(x, z, "solinas", 128))
    times["plain_K14_chain"] = event_ms(
        lambda: mb.chain_plain(x, z, "solinas", 128), reps=1)
    shapes["K14_chain"] = (rows, mb._TL, 128)
    xf = mb.fused_inputs(GF32, 2048, 64, "cuda")
    parent_peaks_ms(x, z, xf)
    del x, z, xf
    # K15: every fused config at 64 row tiles and depth 2, against the
    # plain chain over 32-lane slices; the row is fused_gf32_c2048
    for key, cfg in mb._FUSED_CONFIGS.items():
        field = FIELDS[cfg["field_name"]]
        xf = mb.fused_inputs(field, cfg["c"], 64, "cuda")
        outs = []
        plain_ms = chunked_ms(lambda v: mb.fused_chain_plain(v, field, 2),
                              xf, 32, outs=outs)
        cmp("K15_fused_chain", mb.fused_chain(xf, field, 2),
            torch.cat(outs, dim=-1), (key, "64 row tiles"))
        del outs
        if key == "fused_gf32_c2048_gops":
            times["K15_fused_chain"] = event_ms(
                lambda: mb.fused_chain(xf, GF32, 2))
            times["plain_K15_fused_chain"] = plain_ms
            shapes["K15_fused_chain"] = tuple(xf.shape) + (2,)
        del xf
    torch.cuda.empty_cache()
    say(f"[peaks] at the main path's shapes == plain: K13 (256 MiB, 1 GiB), "
        f"K14 ({len(mb._VARIANTS)} variants, 64 MiB, default depth), K15 "
        f"(3 configs, 64 row tiles, depth 2)")
    for kk in PEAKS:
        say(f"[peaks] {kk} {times[kk]:.4f} ms on {shapes[kk]}, plain "
            f"{times['plain_' + kk]:.1f} ms")

    # the encode's roofline under the published and the measured peaks
    # (a one-pipe model: its compute time can be up to 2x the least time)
    for name, pk in (("published", None), ("measured", peaks)):
        r = profiling.encode_roofline(1 << 20, 1024, peaks=pk)
        say(f"[peaks] encode_roofline(2^20, 1024), one-pipe, {name} peaks: "
            f"{r['speed_of_light_s'] * 1e3:.4f} ms ({r['bound']}-bound; "
            f"memory {r['t_memory_bound_s'] * 1e3:.4f}, compute "
            f"{r['t_compute_bound_s'] * 1e3:.4f} ms); phase encode "
            f"{times['encode_s'] * 1e3:.3f} ms = "
            f"{times['encode_s'] / r['speed_of_light_s']:.2f}x")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi: " + out.stderr.strip())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    import fastecc_tpu_torch  # noqa: F401  (fails outside the repo)
    from fastecc_tpu_torch.fields import GF16, GF32

    t_start = time.perf_counter()
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}; "
        f"uint32 add on the card: {uint32_arithmetic()}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0x5EED)
    phase_build()
    worst = phase_kernels(gen)
    phase_golden()
    launches, times, shapes = {}, {}, {}
    phase_encode(gen, launches, times, shapes)
    phase_ntt(gen, launches, times)
    phase_wire(gen, launches, times)
    phase_wire16(gen, launches, times, shapes)
    phase_decode(gen, launches, times, shapes)
    phase_decode_small(gen, launches, times)
    phase_extras(gen, launches, times)
    phase_lanes(gen, launches, times, shapes)
    phase_errors(gen, launches, times)
    phase_storage(gen, launches, times)
    phase_parallel(launches, times)
    phase_peaks(gen, launches, times, shapes, worst)

    total = {k: sum(p[k] for p in launches.values()) for k in REPLACES}
    for k, v in total.items():
        check(v > 0, f"{k} never launched on the main path")
    card = card_line()
    kernels = []
    for k in REPLACES:
        if k in PEAKS:
            b_ms, b_by = peaks_bound(k, shapes[k])
        else:
            gf16 = k in WIRE16 or k == "K12_pair_lanes_wire16"
            b_ms, b_by = bound(k, GF16 if gf16 else GF32, shapes[k],
                               times["sel_frac"])
        lib = times.get("library_" + k)
        say(f"[kernel] {k}: source {SOURCE[k]}, replaces {REPLACES[k]}, "
            f"timed on {list(shapes[k])}")
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE[k],
            "replaces": REPLACES[k], "launches": total[k],
            "max_abs_err": worst[k], "ms": round(times[k], 4),
            "plain_ms": round(times["plain_" + k], 2),
            "bound_ms": round(b_ms, 4), "bound_by": b_by,
            "library_ms": None if lib is None else round(lib, 4),
        })
    say(f"[summary] encode 2^20 x 1024 GF32: {times['encode_s'] * 1e3:.3f} ms"
        f" = {times['encode_gbps']:.2f} GB/s codeword; NTT 2^20 x 512: "
        f"{times['ntt_s'] * 1e3:.3f} ms; wire 2^14 blocks: "
        f"{times['wire_s'] * 1e3:.3f} ms; decode 2^20 x 512 GF32, e = 2^19: "
        f"{times['decode_s'] * 1e3:.3f} ms = {times['decode_gbps']:.2f} GB/s "
        f"codeword (tables {times['tables_s'] * 1e3:.1f} ms); decode 2^13 x "
        f"1024: {times['decode_small_s'] * 1e3:.3f} ms; wire decode 2^17 "
        f"blocks: {times['wire_decode_s'] * 1e3:.3f} ms; GF16 wire 2^13 x "
        f"64 KB: {times['wire16_s'] * 1e3:.3f} ms = "
        f"{times['wire16_gbps']:.2f} GB/s wire (generic route "
        f"{times['wire16_generic_s'] * 1e3:.3f} ms); lanes pair on/off: "
        f"batch {times['lanes_lanes_s'] * 1e3:.3f}/"
        f"{times['lanes_3pass_s'] * 1e3:.3f} ms, GF16 wire "
        f"{times['lanes_wire16_lanes_s'] * 1e3:.3f}/"
        f"{times['lanes_wire16_3pass_s'] * 1e3:.3f} ms; correct_errors 2^20 "
        f"x 1024: {times['correct_s'] * 1e3:.1f} ms; verify 2^20 x 1024: "
        f"{times['verify_s'] * 1e3:.3f} ms; update 3 blocks: "
        f"{times['update_s'] * 1e3:.3f} ms; sharded GF32 encode 2^20 x 1024 "
        f"on 2x1 ranks sharing the card (Gloo): "
        f"{times['parallel']['2x1_enc32_ms']:.3f} ms; copy "
        f"{times['peaks']['hbm_stream_gbps']} GB/s, raw mul "
        f"{times['peaks']['raw_mul_gops']} Gops/s; "
        f"{time.perf_counter() - t_start:.0f} s total")
    by_path = {path: {k: v for k, v in d.items() if v}
               for path, d in launches.items()}
    say(json.dumps({"launches_by_path": by_path}, separators=(",", ":")))
    say(json.dumps({"kernels": kernels}, separators=(",", ":")))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
