#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``fastecc_tpu_torch`` (never JAX or ``fastecc_tpu``) through its
main path on the card and fails loudly on any fault. Phases:

  1. build   — compile the Hopper kernels from ``fastecc_tpu_torch/csrc``;
  2. kernels — each of K1-K4 against its plain PyTorch version on the
               card, at the shapes phases 4-6 give it (on a 16-lane slice)
               and at small orders with a ragged lane count, both fields;
               bit-exact (``torch.equal``, tolerance 0: exact integer
               arithmetic);
  3. golden  — the JAX package's pinned SHA-256 digests (codewords of
               tests/test_rs.py, GF32 wire blob of tests/test_wire_golden.py)
               reproduced through the kernels;
  4. encode  — rate-1/2 GF32 encode at 2^20 source+parity blocks of
               1024 u32 lanes (k = 2^19, 4 KB blocks), the first and the
               last 8 lanes (first and last lane tile of every pass)
               checked against the plain staged transforms; median of 5
               timed calls; then a rate-1/4 encode (k = 2^18, n = 2^20),
               the path that runs K4, checked the same way;
  5. ntt     — the 2^20-point forward NTT over 512 lanes, first and last
               8 lanes checked against the plain staged transform;
  6. wire    — GF32 encode_blocks on 2^14 random 4 KB blocks, checked
               against encode_parity of the packed data, and its first
               and last 8 lanes (the ragged edge at 1088) against the
               plain staged transforms.

Launch counts are reset to 0 before each main-path run (phases 4-6) and
read right after it; each run must launch every kernel of its path. The
second-to-last line is a JSON object with, per kernel, its launches,
its time at the main-path shape, the plain version's time, and the bound
(the larger of bytes over the memory rate and integer multiplies over
the multiply rate); the last line is the {"ok": true, ...} device
record. Exits non-zero, printing no result, without a CUDA device or
without the package beside it.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

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
}
SOURCE = "fastecc_tpu_torch/csrc/ntt_mfa.cu"


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


def chunked_ms(fn, x: torch.Tensor, chunk: int) -> float:
    """Device time in ms of ``fn`` applied to every ``chunk``-lane slice
    of ``x`` (lanes are the last axis and independent): the plain
    versions at full width need more memory than the card has."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for l0 in range(0, x.shape[-1], chunk):
        fn(x[..., l0:l0 + chunk].contiguous())
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


def pass_mulmods(kind: str, a: int) -> int:
    """Per lane-column multiplies of a pass with transform length a."""
    if kind == "K3_row":
        return stage_mulmods(a)
    if kind == "K1_col":
        return stage_mulmods(a) + a                   # + four-step twiddle
    if kind == "K4_col_pre":
        return stage_mulmods(a) + 2 * a               # + coset, twiddle
    return 2 * stage_mulmods(a) + 2 * a               # seam


def bound(kind: str, field, shape) -> tuple[float, str]:
    a, b, lanes = shape
    nbytes = 2 * 4 * a * b * lanes                    # read once, write once
    # GF32: the two words of a*b; for p = 0xFFF00001 the REDC's m and
    # (m*p) >> 32 are shift/add chains (fastecc_tpu_torch/gf.py mont_mul)
    muls_per_mod = 2 if field.use_mont else 1
    muls = pass_mulmods(kind, a) * b * lanes * muls_per_mod
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
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("[build]", line.strip())


def phase_kernels(gen) -> dict:
    """Each kernel vs its plain version at the shapes the main-path runs
    below give it (on a 16-lane slice), and at small orders with a ragged
    lane count, in both fields; returns the worst error per kernel."""
    from fastecc_tpu_torch.fields import GF16, GF32
    from fastecc_tpu_torch.kernels import ntt_mfa as m

    worst = {k: 0 for k in REPLACES}

    def cmp(name, got, want, what):
        err = max_abs_err(got, want)
        worst[name] = max(worst[name], err)
        check(torch.equal(got, want), f"{name} != plain at {what}")

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

    # main-path shapes: encode_r2 (k = 2^19), encode_r4 (k = 2^18, the
    # coset NTTs' K4), ntt (2^20), wire (k = 2^14); GF16 at its largest
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
    say("[kernels] orders 4, 8, 128, 13 lanes, GF32 and GF16: "
        "K1-K4 == plain")
    return worst


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


def profile_once(fn, name: str) -> None:
    """One call under torch.profiler: device time per kernel name and the
    device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    for dev_us, count, key in sorted(rows, reverse=True)[:6]:
        say(f"[{name}] profiler: {dev_us / 1e3:8.3f} ms x{count} {key}")


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
    from fastecc_tpu_torch.kernels import ntt_mfa
    torch.cuda.synchronize()
    ntt_mfa.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches[name] = dict(ntt_mfa.LAUNCHES)
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
    del data, x4
    torch.cuda.empty_cache()


def phase_ntt(gen, launches, times):
    from fastecc_tpu_torch import ntt
    from fastecc_tpu_torch.fields import GF32
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
    from fastecc_tpu_torch.fields import GF32

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

    total = {k: sum(p[k] for p in launches.values()) for k in REPLACES}
    for k, v in total.items():
        check(v > 0, f"{k} never launched on the main path")
    card = card_line()
    kernels = []
    for k in REPLACES:
        b_ms, b_by = bound(k, GF32, shapes[k])
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[k], "launches": total[k],
            "max_abs_err": worst[k], "ms": round(times[k], 4),
            "plain_ms": round(times["plain_" + k], 2),
            "bound_ms": round(b_ms, 4), "bound_by": b_by,
            "library_ms": None, "shape": list(shapes[k]),
        })
    say(f"[summary] encode 2^20 x 1024 GF32: {times['encode_s'] * 1e3:.3f} ms"
        f" = {times['encode_gbps']:.2f} GB/s codeword; NTT 2^20 x 512: "
        f"{times['ntt_s'] * 1e3:.3f} ms; wire 2^14 blocks: "
        f"{times['wire_s'] * 1e3:.3f} ms; {time.perf_counter() - t_start:.0f}"
        f" s total")
    say(card)
    say(json.dumps({"card": card, "kernels": kernels,
                    "launches_by_path": launches}, separators=(",", ":")))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
