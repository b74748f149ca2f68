"""Command-line interface of the port: the counterpart of ``cli.py``.

    python -m fastecc_tpu_torch.cli verify --lg-n 10       # fast vs slow
    python -m fastecc_tpu_torch.cli roundtrip --lg-n 16    # intt(ntt(x))
    python -m fastecc_tpu_torch.cli gf-bench --variant all # the peaks
    python -m fastecc_tpu_torch.cli ntt-bench --lg-n 20    # NTT GB/s
    python -m fastecc_tpu_torch.cli rs-bench --lg-k 19     # encode GB/s
    python -m fastecc_tpu_torch.cli decode-bench --lg-n 13 --lg-e 12
    python -m fastecc_tpu_torch.cli roofline --pipeline encode --lg-n 20
    python -m fastecc_tpu_torch.cli encode FILE -o DIR     # write parity
    python -m fastecc_tpu_torch.cli recover DIR -o FILE [--check]
    python -m fastecc_tpu_torch.cli check DIR              # CRC + algebra
    python -m fastecc_tpu_torch.cli repair DIR             # re-replicate
    python -m fastecc_tpu_torch.cli read DIR --offset N --length L
    python -m fastecc_tpu_torch.cli update DIR FILE --offset N
    python -m fastecc_tpu_torch.cli scaling --op encode --devices 4
    python -m fastecc_tpu_torch.cli scaling --procs 4 [--update-baseline]

Every command runs on the card unless ``--device cpu`` (the kernels'
plain versions); without a GPU it raises. Output lines, JSON keys, exit
codes and the files written are the reference's; each JSON line adds
``device``. ``gf-bench`` runs the microbenchmark kernels (K13 copy, K14
chains, K15 fused chains; ``--variant torch`` times ``gf.mul`` as
framework ops), ``roofline`` prints a pipeline's speed-of-light bound from
the published H100 peaks or a ``gf-bench --variant all`` line given as
``--peaks-json``. ``rs-bench`` and ``decode-bench`` take ``--seam off``
(the two staged transforms in place of the three-pass pair, on the same
call path); the reference's ``--pair-c-dim`` is refused, because the
pair's split is the port's own policy (``kernels.ntt_mfa._pair_split``).

The file commands: ``encode`` splits FILE into 4 KB data blocks
(zero-padded tail, original size in manifest.json) and writes the parity
blocks and the manifest into DIR; ``recover`` rebuilds FILE from any >= k
surviving block files; ``check`` audits (CRC, then the algebraic codeword
property, locating silently corrupted blocks); ``repair`` rewrites every
missing or corrupt block file; ``read`` serves a byte range, decoding only
the touched column window of missing blocks; ``update`` splices new bytes
in with incremental parity updates. Files beyond ``--max-resident`` MB
stream through ``storage``; files beyond one codeword stripe. The
directories are the reference's, byte for byte.

``scaling`` runs the sharded codec (``parallel``) on worlds of 1, 2, 4,
... ranks, one process each (``parallel._worker.launch``): a weak-scaling
row per world, or with ``--procs N`` one structural row of N ranks. Its
rows add ``backend`` (NCCL when every rank has a card of its own, else
Gloo) and ``virtual`` (ranks sharing a card, or the CPU: not a scaling
measurement).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys

import numpy as np


def _field(name: str):
    from .fields import FIELDS
    return FIELDS[name.upper()]


def _rand(field, shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _device_name(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


# ---------------------------------------------------------------------------
# verify / bench modes (the reference `ntt` and `rs` binaries)
# ---------------------------------------------------------------------------

def cmd_verify(args, dev):
    """Fast NTT vs naive O(N^2) DFT, plus the four-step cross-check."""
    from . import ntt as nttmod
    from .interop import as_tensor, to_numpy_u32
    field = _field(args.field)
    n = 1 << args.lg_n
    if args.lg_n > 10:
        raise SystemExit("verify: the naive oracle is O(N^2); use "
                         "roundtrip beyond --lg-n 10")
    x = _rand(field, (n, args.lanes))
    want = nttmod.naive_dft(x, field)
    xt = as_tensor(x, dev)
    got = to_numpy_u32(nttmod.ntt(xt, field))
    mfa = to_numpy_u32(nttmod.ntt_four_step(xt, field))
    ok = (got == want).all() and (mfa == want).all()
    print(f"verify lg_n={args.lg_n} {field.name}: "
          f"{'PASS' if ok else 'FAIL'} (stockham & four-step vs naive DFT)")
    return 0 if ok else 1


def cmd_roundtrip(args, dev):
    from . import ntt as nttmod
    from .interop import as_tensor, to_numpy_u32
    field = _field(args.field)
    n = 1 << args.lg_n
    x = _rand(field, (n, args.lanes))
    back = to_numpy_u32(nttmod.intt(nttmod.ntt(as_tensor(x, dev), field),
                                    field))
    ok = (back == x).all()
    print(f"roundtrip lg_n={args.lg_n} {field.name}: "
          f"{'PASS' if ok else 'FAIL'} (intt(ntt(x)) == x)")
    return 0 if ok else 1


def cmd_gf_bench(args, dev):
    """Microbenchmarks (the reference ``ntt`` binary's mulmod A/B): one
    chain variant, the copy (``stream``), the whole peaks table (``all``),
    or ``torch``: ``gf.mul`` as framework ops over 2^lg_size elements."""
    device = _device_name(dev)
    if args.variant != "torch":
        from .kernels import microbench
        if args.variant == "all":
            peaks = microbench.measure_peaks(iters=args.iters, device=dev)
            print(json.dumps({"op": "gf_peaks", **peaks, "device": device}))
        elif args.variant == "stream":
            v = microbench.hbm_stream_gbps(iters=args.iters, device=dev)
            print(json.dumps({"op": "hbm_stream", "gb_per_sec": round(v, 1),
                              "device": device}))
        else:
            gops = microbench.vpu_chain_gops(args.variant, iters=args.iters,
                                             device=dev)
            print(json.dumps({"op": "gf_chain", "variant": args.variant,
                              "gops": round(gops, 1), "device": device}))
        return 0
    from . import gf, interop
    from .utils.timer import time_fn
    field = _field(args.field)
    m = 1 << args.lg_size
    a = interop.from_numpy_u32(_rand(field, (m,), 1), dev)
    b = interop.from_numpy_u32(_rand(field, (m,), 2), dev)
    secs = time_fn(lambda u, v: gf.mul(field, u, v), a, b, iters=args.iters)
    print(json.dumps({"op": "gf_mul", "field": field.name, "elements": m,
                      "seconds": round(secs, 6),
                      "ops_per_sec": round(m / secs / 1e9, 3),
                      "unit": "Gmul/s", "device": device}))
    return 0


def cmd_ntt_bench(args, dev):
    """NTT throughput; ``--algo`` mirrors the reference ``ntt`` binary's
    algorithm selector: auto (the kernels), stockham and fourstep (torch
    ops), pallas (the fused two-pass kernels, ``ntt_mfa.ntt_fused``)."""
    from . import ntt as nttmod
    from .interop import as_tensor
    from .kernels import ntt_mfa
    from .utils.timer import time_fn
    field = _field(args.field)
    n = 1 << args.lg_n
    x = as_tensor(_rand(field, (n, args.lanes)), dev)
    algo = {
        "auto": lambda v: nttmod.ntt_auto(v, field, inverse=args.inverse),
        "stockham": lambda v: nttmod.ntt(v, field, inverse=args.inverse,
                                         radix=args.radix),
        "fourstep": lambda v: nttmod.ntt_four_step(v, field,
                                                   inverse=args.inverse),
        "pallas": lambda v: ntt_mfa.ntt_fused(v, field,
                                              inverse=args.inverse),
    }[args.algo]
    secs = time_fn(algo, x, iters=args.iters)
    gb = x.numel() * 4 / 1e9
    print(json.dumps({"op": "intt" if args.inverse else "ntt",
                      "algo": args.algo, "radix": args.radix,
                      "field": field.name, "lg_n": args.lg_n,
                      "lanes": args.lanes, "seconds": round(secs, 4),
                      "gb_per_sec": round(gb / secs, 2),
                      "device": _device_name(dev)}))
    return 0


@contextlib.contextmanager
def _seam_dispatch(mode: str):
    """Scope the pair switch (``ntt_mfa.PAIR_ENABLED``) to one bench
    command: "off" runs the two staged transforms in place of the
    three-pass pair on the same call path, and the switch is restored on
    exit so no later call in the process is demoted."""
    from .kernels import ntt_mfa
    prev = ntt_mfa.PAIR_ENABLED
    if mode == "off":
        ntt_mfa.PAIR_ENABLED = False
    try:
        yield
    finally:
        ntt_mfa.PAIR_ENABLED = prev


def cmd_rs_bench(args, dev):
    """RS encode throughput. ``--seam on/off`` A/Bs the three-pass pair
    (K1 -> K2 -> K3) against the two staged transforms (K1 -> K3, K4 ->
    K3; the same bits); ``auto`` is the production dispatch."""
    from . import rs
    from .interop import as_tensor
    from .kernels import ntt_mfa
    from .utils.timer import time_fn
    field = _field(args.field)
    k, n = 1 << args.lg_k, 1 << (args.lg_k + 1)
    x = as_tensor(_rand(field, (k, args.lanes)), dev)
    if args.seam == "on":
        w_n = field.root_of_order(n)

        def fn(v):
            return ntt_mfa.ntt_coset_pair(v, field, w_n)
    else:
        # the production call path; "off" turns the pair off for this
        # command only
        def fn(v):
            return rs.encode_parity(v, field, n)
    with _seam_dispatch(args.seam):
        secs = time_fn(fn, x, iters=args.iters)
    # wire-format word size (GF16 lanes are 2-byte words on the wire);
    # both the codeword-bytes and the computed-parity-bytes rate
    wb = 4 if field.use_mont else 2
    gb = n * args.lanes * wb / 1e9
    pgb = (n - k) * args.lanes * wb / 1e9
    print(json.dumps({"op": "rs_encode", "field": field.name,
                      "k": k, "n": n, "lanes": args.lanes,
                      "wire_word_bytes": wb, "seam": args.seam,
                      "seconds": round(secs, 4),
                      "gb_per_sec": round(gb / secs, 2),
                      "parity_gb_per_sec": round(pgb / secs, 2),
                      "device": _device_name(dev)}))
    return 0


def cmd_decode_bench(args, dev):
    """Erasure-decode throughput: recover e erased rows of an [n, lanes]
    codeword (BASELINE.json:10 at --lg-n 13 --lg-e 12)."""
    import time

    import torch

    from . import decode as dec
    from . import rs
    from .interop import as_tensor
    from .utils.timer import fence, time_fn
    field = _field(args.field)
    n, e = 1 << args.lg_n, 1 << args.lg_e
    if e >= n:
        raise SystemExit(f"decode-bench: need --lg-e < --lg-n, got "
                         f"{args.lg_e} and {args.lg_n}")
    k = n // 2
    cw = rs.encode(as_tensor(_rand(field, (k, args.lanes)), dev), field, n)
    rng = np.random.default_rng(args.seed)
    erased = np.sort(rng.choice(n, size=e, replace=False)).astype(np.uint32)
    # garble the erased rows so recovered_ok proves recovery (a
    # passthrough decode must FAIL this check)
    gj = cw.clone()
    gj.view(torch.int32)[as_tensor(erased.astype(np.int64), dev)] = \
        as_tensor(_rand(field, (e, args.lanes), seed=args.seed + 1),
                  dev).view(torch.int32)
    loc_secs = None
    # --seam off turns the three-pass pair off for the identical decode
    # call path (restored on exit)
    with _seam_dispatch(args.seam):
        if args.device_locator:
            idx = as_tensor(erased, dev)

            def fn(c):
                return dec.decode(c, idx, field, k=k)
            locator = "fused-device"
        else:
            # product path: build the locator tables ONCE (their one-time
            # cost reports separately), then time the steady-state decode
            t0 = time.perf_counter()
            targs = fence(dec.prepare_decode_tables(erased, n, field,
                                                    device=dev))
            loc_secs = round(time.perf_counter() - t0, 3)

            def fn(c):
                return dec.decode_prepared(c, *targs, field)
            locator = "prepared"
        secs = time_fn(fn, gj, iters=args.iters)
        out = fn(gj)
    ok = bool(torch.equal(out, cw))
    wb = 4 if field.use_mont else 2
    gb = n * args.lanes * wb / 1e9
    print(json.dumps({"op": "rs_decode", "field": field.name,
                      "n": n, "erasures": e, "lanes": args.lanes,
                      "locator": locator,
                      "seconds": round(secs, 4),
                      "locator_build_seconds": loc_secs,
                      "gb_per_sec": round(gb / secs, 2),
                      "recovered_gb_per_sec": round(
                          e * args.lanes * wb / 1e9 / secs, 2),
                      "recovered_ok": ok, "device": _device_name(dev)}))
    return 0 if ok else 1


def cmd_roofline(args, dev):
    """Speed-of-light bound for a pipeline config: the port's per-element
    integer op counts priced at the peaks' op rates, against the memory
    passes at the peaks' memory rate. No device work: the peaks are the
    published H100 rates unless ``--peaks-json`` gives measured ones."""
    from .utils import profiling

    peaks = None
    if args.peaks_json:
        with open(args.peaks_json) as fh:
            peaks = json.load(fh)
        peaks.pop("op", None)   # accept gf-bench's JSON line verbatim
        peaks.pop("device", None)
    field = _field(args.field)
    n = 1 << args.lg_n
    seam = args.seam != "off"
    if args.pipeline == "encode":
        r = profiling.encode_roofline(n, args.lanes, peaks=peaks,
                                      field_name=field.name, seam=seam)
    elif args.pipeline == "decode":
        r = profiling.decode_roofline(n, args.lanes, peaks=peaks,
                                      field_name=field.name, seam=seam)
    elif args.pipeline == "encode-wire":
        # GF16's fused wire pair is the seam path; GF32 has no fused form
        r = profiling.encode_blocks_roofline(
            n, args.block_bytes, field_name=field.name,
            fused=(field.name == "GF16" and seam), peaks=peaks)
    elif args.pipeline == "decode-wire":
        r = profiling.decode_blocks_roofline(
            n, args.block_bytes, field_name=field.name, peaks=peaks)
    else:
        r = profiling.ntt_roofline(n, args.lanes, peaks=peaks,
                                   field_name=field.name)
    out = {"op": "roofline", "pipeline": args.pipeline,
           "field": field.name, "lg_n": args.lg_n, "lanes": args.lanes,
           "seam": None if args.pipeline == "ntt" else seam}
    out.update({k: round(v, 6) if isinstance(v, float) else v
                for k, v in r.items()})
    if field.name == "GF16" and args.pipeline in ("encode", "decode",
                                                  "ntt"):
        # a GF16 lane is a 2-byte wire word: the u32 rate is exactly 2x
        out["speed_of_light_wire_gbps"] = round(
            r["speed_of_light_gbps"] / 2, 6)
    print(json.dumps(out))
    return 0


# ---------------------------------------------------------------------------
# file-level encode / recover (the product path, end to end)
# ---------------------------------------------------------------------------

def _load_survivors(src: pathlib.Path, man: dict, quiet: bool = False):
    """Scan a coded directory's block files against its manifest.

    Shared by recover/check/repair. Validates each file's position and
    size and CRC-checks it whenever the manifest has tags (native CRC32C
    when the library loads, the bit-identical numpy twin otherwise: CRC
    never silently disappears); invalid files are excluded (flagged,
    never fatal: the caller decides recoverability). Returns (survivors,
    flagged, crc_verified) where ``flagged`` lists (position, reason) for
    every excluded file."""
    from . import host, packing, rs
    field = _field(man["field"])
    n, k = man["n"], man["k"]
    bb = man.get("block_bytes", 4096)
    dpos = set(rs.data_positions(n, k).tolist())
    tags = man.get("crc32c") or {}
    if tags:
        host.available() or host.build()   # prefer the OpenMP path
    crc = bool(tags)
    survivors, flagged = {}, []

    def flag(pos, reason):
        flagged.append((pos, reason))
        if not quiet:
            print(f"block {pos}: {reason} — treating as erased")

    for f in sorted(src.glob("block_*.dat")) + sorted(src.glob("block_*.par")):
        try:
            pos = int(f.stem.split("_")[1])
        except (IndexError, ValueError):
            continue                      # not ours
        if not 0 <= pos < n:
            flag(pos, "position out of range")
            continue
        blob = f.read_bytes()
        want = bb if pos in dpos else packing.parity_bytes(field, bb)
        if len(blob) != want:
            flag(pos, f"bad size {len(blob)} != {want}")
            continue
        if crc and str(pos) in tags and host.crc32c(blob) != tags[str(pos)]:
            flag(pos, "CRC mismatch")
            continue
        survivors[pos] = blob
    return survivors, flagged, crc


def _file_blocks(path: pathlib.Path, block_bytes: int):
    raw = np.fromfile(path, dtype=np.uint8)
    k_data = max(1, -(-raw.size // block_bytes))
    k = 1 << (k_data - 1).bit_length()           # round up to power of two
    blocks = np.zeros((k, block_bytes), np.uint8)
    blocks.reshape(-1)[: raw.size] = raw
    return blocks, raw.size, k


def cmd_encode(args, dev):
    from . import host, rs, storage
    from .interop import as_tensor
    from .packing import _word_count
    field = _field(args.field)
    src = pathlib.Path(args.file)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.block_bytes <= 0:
        raise SystemExit("--block-bytes must be positive")
    _word_count(field, args.block_bytes)   # loud word-alignment check
    max_resident = args.max_resident << 20
    total_blocks = max(1, -(-src.stat().st_size // args.block_bytes))
    if total_blocks > storage.stripe_capacity_blocks(field):
        # beyond one codeword's capacity (n = 2k caps at the transform
        # order): stripe across self-contained codeword subdirectories
        man = storage.encode_file(
            src, out, field, block_bytes=args.block_bytes,
            max_resident_bytes=max_resident, device=dev)
        print(f"encoded {src} ({man['size']} bytes, "
              f"{len(man['stripes'])} stripes x {man['stripe_blocks']} "
              f"data blocks, streamed) -> {out}")
        return 0
    if src.stat().st_size > max_resident:
        # out-of-core path: memmap and lane-chunk streaming (storage); the
        # directory is bit-identical to the in-core path below
        man = storage.encode_file_stream(
            src, out, field, block_bytes=args.block_bytes,
            max_resident_bytes=max_resident, device=dev)
        print(f"encoded {src} ({man['size']} bytes, streamed) -> "
              f"{man['k']} data + {man['k']} parity blocks in {out}")
        return 0
    blocks, size, k = _file_blocks(src, args.block_bytes)
    n = 2 * k
    parity = rs.encode_blocks(as_tensor(blocks, dev), field, n).cpu().numpy()
    dpos, ppos = rs.data_positions(n, k), rs.parity_positions(n, k)
    # per-block CRC32C integrity tags (recover uses them to demote
    # silently corrupted blocks to erasures); native OpenMP when it
    # builds, the bit-identical numpy twin otherwise: always tagged
    host.available() or host.build()
    tags = {}
    dtags = host.crc32c_blocks(blocks)            # one batched call
    ptags = host.crc32c_blocks(parity)
    for i in range(k):
        tags[int(dpos[i])] = int(dtags[i])
        tags[int(ppos[i])] = int(ptags[i])
    for i in range(k):
        (out / f"block_{int(dpos[i]):06d}.dat").write_bytes(
            blocks[i].tobytes())
        (out / f"block_{int(ppos[i]):06d}.par").write_bytes(
            parity[i].tobytes())
    (out / "manifest.json").write_text(json.dumps({
        "file": src.name, "size": size, "k": k, "n": n,
        "field": field.name, "format": "fastecc-tpu-v1",
        "block_bytes": args.block_bytes,
        "crc32c": {str(p): t for p, t in tags.items()} or None}))
    print(f"encoded {src} ({size} bytes) -> {k} data + {k} parity blocks "
          f"in {out}")
    return 0


def _codeword_bytes(man) -> int:
    from . import packing
    field = _field(man["field"])
    bb = man.get("block_bytes", 4096)
    return man["n"] * packing.field_lanes(field, bb) * 4


def cmd_recover(args, dev):
    from . import decode as dec
    from . import storage
    src = pathlib.Path(args.dir)
    man = json.loads((src / "manifest.json").read_text())
    if storage.is_striped(man):
        wrote = storage.recover_file(
            src, pathlib.Path(args.out),
            max_resident_bytes=args.max_resident << 20,
            check=args.check, progress=print, device=dev)
        print(f"recovered {man['file']} -> {args.out} ({man['size']} "
              f"bytes, {len(man['stripes'])} stripes, {wrote} blocks "
              f"reconstructed)")
        return 0
    field = _field(man["field"])
    n, k, size = man["n"], man["k"], man["size"]
    out = pathlib.Path(args.out)
    if _codeword_bytes(man) > args.max_resident << 20:
        wrote = storage.recover_file_stream(
            src, out, max_resident_bytes=args.max_resident << 20,
            check=args.check, progress=print, device=dev)
        print(f"recovered {man['file']} -> {out} ({size} bytes, "
              f"{wrote} blocks reconstructed, streamed)")
        return 0
    survivors, _, _ = _load_survivors(src, man)
    lost = n - len(survivors)
    print(f"{len(survivors)}/{n} blocks present ({lost} lost); "
          f"need any {k}")
    data = dec.decode_blocks(survivors, n, k, field,
                             block_bytes=man.get("block_bytes", 4096),
                             check=args.check, device=dev).cpu().numpy()
    out.write_bytes(data.reshape(-1)[:size].tobytes())
    print(f"recovered {man['file']} -> {out} ({size} bytes)")
    return 0


def cmd_check(args, dev):
    """Audit a coded directory: CRC every block file, then (if complete)
    verify the algebraic codeword property in one inverse transform.

    Exit codes: 0 = healthy; 1 = degraded but recoverable (>= k
    survivors, including silently corrupted blocks that were LOCATED
    algebraically, status "corrupt-located"); 2 = unrecoverable (< k
    survivors); 3 = inconsistent but not locatable (corruption beyond
    capacity or a degenerate pattern: something lied and repair cannot
    fix it). Algebraic location finds at most min((n-k-e)/2, 16384)
    silently corrupt rows (``decode._BM_MAX``); CRC-tagged corruption is
    caught block by block regardless.

    Directories whose codeword exceeds --max-resident stream through a
    memmap stage and lane-chunked verification (storage.check_file_stream)
    instead of loading every survivor blob into RAM."""
    from . import decode as dec
    from . import rs, storage
    from .interop import as_tensor
    src = pathlib.Path(args.dir)
    man = json.loads((src / "manifest.json").read_text())
    device = _device_name(dev)
    if storage.is_striped(man):
        report, rc = storage.check_file(
            src, max_resident_bytes=args.max_resident << 20, device=dev)
        print(json.dumps({**report, "device": device}))
        return rc
    field = _field(man["field"])
    n, k = man["n"], man["k"]
    bb = man.get("block_bytes", 4096)
    if _codeword_bytes(man) > args.max_resident << 20:
        report, rc = storage.check_file_stream(
            src, max_resident_bytes=args.max_resident << 20, device=dev)
        print(json.dumps({**report, "device": device}))
        return rc
    survivors, flagged, crc_verified = _load_survivors(src, man, quiet=True)
    missing = sorted(set(range(n)) - set(survivors))
    consistent = None
    located = None
    if not missing:
        cw, _ = dec.survivors_to_codeword(survivors, n, k, field, bb)
        cw = as_tensor(cw, dev)
        consistent = bool(rs.verify_codeword(cw, field, k))
        if not consistent:
            # corruption the CRC missed (or forged tags): locate the bad
            # rows algebraically (Berlekamp-Massey on the syndromes);
            # `repair` can then fix them without any CRC evidence
            pos = dec.locate_errors(cw, k, field)
            if pos is not None and pos.size:
                located = [int(x) for x in pos]
    status, recoverable, rc = storage.status_ladder(
        consistent, located, len(missing), len(survivors), k)
    print(json.dumps({
        "n": n, "k": k, "present": len(survivors),
        "flagged": [[p, why] for p, why in flagged],
        "missing_or_corrupt": missing,
        "located_corrupt": located,
        "crc_verified": crc_verified,
        "codeword_consistent": consistent,
        "recoverable": recoverable,
        "status": status, "device": device}))
    return rc


def cmd_repair(args, dev):
    """Regenerate missing or corrupt block FILES in a coded directory.

    The storage-maintenance workflow (re-replication after loss): where
    `recover` reconstructs the original file, `repair` rewrites every
    missing codeword block, data and parity, so the directory is back at
    full n-of-n redundancy. Silently corrupt blocks (wrong bytes,
    valid-looking files) are located algebraically up to
    min((n-k-e)/2, 16384) rows per stripe and rewritten too, forged
    manifest CRCs included."""
    from . import decode as dec
    from . import host, rs, storage
    from .interop import as_tensor, to_numpy_u32
    src = pathlib.Path(args.dir)
    man = json.loads((src / "manifest.json").read_text())
    if storage.is_striped(man):
        wrote = storage.recover_file(
            src, None, max_resident_bytes=args.max_resident << 20,
            repair=True, check=True, progress=print, device=dev)
        print(f"repaired {wrote} blocks in {src} "
              f"({len(man['stripes'])} stripes)")
        return 0
    field = _field(man["field"])
    n, k = man["n"], man["k"]
    bb = man.get("block_bytes", 4096)
    tags = man.get("crc32c") or {}
    if _codeword_bytes(man) > args.max_resident << 20:
        wrote = storage.recover_file_stream(
            src, None, max_resident_bytes=args.max_resident << 20,
            repair=True, check=True, progress=print, device=dev)
        print(f"repaired {wrote} blocks in {src} (streamed)")
        return 0
    survivors, _, _ = _load_survivors(src, man)
    missing = sorted(set(range(n)) - set(survivors))
    dpos = set(rs.data_positions(n, k).tolist())
    if not missing:
        # no missing or CRC-flagged files: audit algebraically and repair
        # any silently corrupted rows at UNKNOWN positions (corruption
        # that defeated or forged the CRC tags)
        cw, _ = dec.survivors_to_codeword(survivors, n, k, field, bb)
        cw = as_tensor(cw, dev)
        if bool(rs.verify_codeword(cw, field, k)):
            print("nothing to repair")
            return 0
        fixed, pos = dec.correct_errors(cw, k, field)
        full = to_numpy_u32(fixed)
        missing = [int(x) for x in pos]
        print(f"located {len(missing)} silently corrupted blocks "
              f"algebraically: {missing}")
    else:
        if len(survivors) < k:
            raise SystemExit(f"unrecoverable: {len(survivors)} survivors "
                             f"< k={k}")
        cw, _ = dec.survivors_to_codeword(survivors, n, k, field, bb)
        cw = as_tensor(cw, dev)
        dec_full = dec.decode_host_prepared(cw, np.asarray(missing), field,
                                            k=k)
        if not bool(rs.verify_codeword(dec_full, field, k)):
            # a SURVIVOR was silently corrupted on top of the missing
            # files: errors-and-erasures correction (e + 2t <= n-k)
            dec_full, pos = dec.correct_errors(cw, k, field,
                                               erased=np.asarray(missing))
            located_set = {int(x) for x in pos}
            missing = sorted(set(missing) | located_set)
            print(f"located {len(located_set)} silently corrupted "
                  f"survivors algebraically: {sorted(located_set)}")
        full = to_numpy_u32(dec_full)
    # Batched emission: one unpack/serialize and one CRC call per 256
    # rows. Every branch above ends in an algebraically VERIFIED codeword
    # (verify_codeword or correct_errors' own audit), so a stored tag that
    # disagrees with a reconstruction is stale or forged (e.g. a crash
    # between a block write and its manifest write) and is re-tagged
    # rather than dead-ending the repair.
    retagged = []
    for kind, suffix, poss in (
            ("data", "dat", [p for p in missing if p in dpos]),
            ("parity", "par", [p for p in missing if p not in dpos])):
        for s in range(0, len(poss), 256):
            grp = poss[s: s + 256]
            blobs = storage._rows_to_blobs(full[grp], field, bb, kind)
            crcs = host.crc32c_blocks(blobs) if tags else None
            for j, pos in enumerate(grp):
                if tags and str(pos) in tags and \
                        int(crcs[j]) != tags[str(pos)]:
                    tags[str(pos)] = int(crcs[j])
                    retagged.append(pos)
                (src / f"block_{pos:06d}.{suffix}").write_bytes(
                    blobs[j].tobytes())
    if retagged:
        man["crc32c"] = tags
        (src / "manifest.json").write_text(json.dumps(man))
        print(f"re-tagged {len(retagged)} forged/stale manifest CRCs")
    print(f"repaired {len(missing)} blocks in {src}")
    return 0


def cmd_read(args, dev):
    """Ranged read, the serving primitive: bytes [--offset, --offset +
    --length) of the encoded payload without recovering the file. Missing
    or CRC-lying covering blocks trigger a degraded read: an erasure
    decode restricted to the word-column window the range touches."""
    from . import storage
    data = storage.read_file(args.dir, args.offset, args.length, device=dev)
    if args.out:
        pathlib.Path(args.out).write_bytes(data)
        print(f"read {len(data)} bytes at offset {args.offset} "
              f"-> {args.out}")
    else:
        sys.stdout.buffer.write(data)
    return 0


def cmd_update(args, dev):
    """Incremental partial write: splice FILE's bytes into the encoded
    payload at --offset and update the touched data blocks and all parity
    files in place (rank-1 parity updates instead of a re-encode). The
    directory stays bit-identical to a fresh encode of the edited
    payload."""
    from . import storage
    data = pathlib.Path(args.file).read_bytes()
    nblocks = storage.update_file(args.dir, args.offset, data, device=dev)
    print(f"updated {nblocks} data block(s) + parity at offset "
          f"{args.offset} ({len(data)} bytes)")
    return 0


# ---------------------------------------------------------------------------
# scaling: the sharded codec over worlds of ranks
# ---------------------------------------------------------------------------

def _sig6(x: float) -> float:
    """``x`` to 6 significant digits (a toy CPU row must not read 0.0)."""
    return float(f"{x:.6g}")


def _virtual(dev, ranks: int) -> bool:
    """True when ranks share a card or run on the CPU: the row is then
    structural, not a measurement of scaling."""
    import torch
    return dev.type != "cuda" or ranks > torch.cuda.device_count()


def _append_baseline_scaling_row(path, row):
    """Append one virtual-tagged structural row to the BASELINE.md at
    ``path`` (the reference's format, with the port's transport and
    device)."""
    import datetime
    import subprocess
    header = "## Multihost structural proxies (virtual — NOT perf data)"
    try:
        commit = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                                capture_output=True, text=True,
                                cwd=pathlib.Path(path).resolve().parent
                                ).stdout.strip() or "?"
    except FileNotFoundError:       # git is not installed
        commit = "?"
    ph, a2a = row["phases"], row["all_to_all"]
    who = ("Virtual: ranks sharing one device" if row["virtual"]
           else "Ranks on devices of their own")
    line = (f"- {datetime.date.today()} ({commit}): "
            f"{row['process_count']}-process {row['mesh']} "
            f"{row['transport']} mesh on {row['device']} (PyTorch port), "
            f"{row['field']} n=2^{row['lg_n']}: all_to_all per program "
            f"ntt/encode/decode = {a2a['ntt']}/{a2a['encode']}/"
            f"{a2a['decode']}; phase walls ntt {ph['ntt_s']} s, "
            f"encode {ph['encode_s']} s, decode {ph['decode_s']} s; "
            f"bit-exact vs single-process: {row['bit_exact']}. "
            f"{who} over {row['transport']} — "
            f"structural readiness for [BASELINE] config :11, not a "
            f"throughput row.\n")
    p = pathlib.Path(path)
    text = p.read_text() if p.exists() else "# BASELINE\n"
    if header not in text:
        text = text.rstrip("\n") + f"\n\n{header}\n\n"
    else:
        text = text.rstrip("\n") + "\n"
    p.write_text(text + line)


def _scaling_multiproc(args, dev):
    """One structural row from ``--procs`` ranks over a 2x2 (4 ranks) or
    Nx1 mesh at the reference's size (lg_n = min(lg_k + 1, 10)): the
    phases' walls, the exchanges per program (``ntt_dist.COLLECTIVES``),
    and every rank's shard held to the single-device port."""
    import tempfile

    from . import decode, ntt, rs
    from .interop import as_tensor, to_numpy_u32
    from .parallel import _worker
    field = _field(args.field)
    procs = args.procs
    mesh_c, mesh_b = (2, 2) if procs == 4 else (procs, 1)
    lg_n = min(args.lg_k + 1, 10)
    n = 1 << lg_n
    k = n // 2
    rng = np.random.default_rng(0)
    x = rng.integers(0, field.p, (n, args.lanes), dtype=np.uint64).astype(
        np.uint32)
    cw = to_numpy_u32(rs.encode(as_tensor(x[:k], dev), field, n))
    erased = np.sort(rng.choice(n, size=k, replace=False))
    garbled = cw.copy()
    garbled[erased] = 0
    want = {"ntt": to_numpy_u32(ntt.ntt_auto(as_tensor(x, dev), field)),
            "encode": to_numpy_u32(rs.encode_parity(as_tensor(x[:k], dev),
                                                    field, n)),
            "decode": cw}
    with tempfile.TemporaryDirectory(prefix="fecc_scaling_") as td:
        def npy(name, a):
            path = str(pathlib.Path(td) / f"{name}.npy")
            np.save(path, a)
            return path
        common = {"field": field.name, "iters": 2}
        cases = [
            {"name": "ntt", "op": "ntt", "input": {"npy": npy("x", x)},
             "want": npy("want_ntt", want["ntt"]), **common},
            {"name": "encode", "op": "encode",
             "input": {"npy": npy("data", x[:k])}, "args": {"n": n},
             "want": npy("want_encode", want["encode"]), **common},
            {"name": "decode", "op": "decode_prepared",
             "input": {"npy": npy("garbled", garbled)},
             "args": {"erased": npy("erased", erased)},
             "want": npy("want_decode", cw), **common},
        ]
        reports = _worker.launch({"mesh": (mesh_c, mesh_b),
                                  "device": dev.type, "cases": cases,
                                  "threads": 1 if dev.type == "cpu" else 0},
                                 procs, timeout=550)
    r0 = reports[0]["cases"]
    row = {"phases": {f"{c}_s": round(min(r0[c]["samples"]), 4)
                      for c in ("ntt", "encode", "decode")},
           "all_to_all": {c: r0[c]["collectives"]["all_to_all"]
                          for c in ("ntt", "encode", "decode")},
           "bit_exact": all(r["cases"][c]["bit_exact"] for r in reports
                            for c in ("ntt", "encode", "decode")),
           "process_count": procs, "devices": procs,
           "virtual": _virtual(dev, procs),
           "transport": reports[0]["backend"],
           "mesh": f"{mesh_c}x{mesh_b}", "field": field.name, "lg_n": lg_n,
           "device": _device_name(dev)}
    print(json.dumps(row))
    if args.update_baseline:
        _append_baseline_scaling_row(args.baseline_path, row)
    return 0 if row["bit_exact"] else 1


def cmd_scaling(args, dev):
    """Weak-scaling sweep over worlds of d = 1, 2, 4, ... <= --devices
    ranks (one process each, a d x 1 mesh), the data [k, lanes * d]: one
    JSON row per world with the reference's keys plus ``backend`` and
    ``device``. Ranks sharing one card (or the CPU) make a ``virtual``
    row: a structural check, never a scaling measurement. ``--procs N``
    prints the structural row of N ranks instead (``--update-baseline``
    appends it to ``--baseline-path``)."""
    if args.procs > 1:
        return _scaling_multiproc(args, dev)
    from .parallel import _worker
    field = _field(args.field)
    k = 1 << args.lg_k
    op = {"encode": "encode", "decode": "decode", "ntt": "ntt",
          "ntt-overlap": "ntt_overlap"}[args.op]
    d, base = 1, None
    while d <= args.devices:
        lanes = args.lanes * d                     # weak scaling: grow work
        case = {"name": "op", "op": op, "field": field.name,
                "iters": args.iters,
                "input": ({"codeword": [k, lanes], "seed": 0, "e": k}
                          if op == "decode"
                          else {"seeded": [k, lanes], "seed": 0})}
        if op == "encode":
            case["args"] = {"n": 2 * k}
        elif op == "ntt_overlap":
            case["args"] = {"chunks": min(args.overlap_chunks, args.lanes)}
        rep = _worker.launch({"mesh": (d, 1), "device": dev.type,
                              "cases": [case],
                              "threads": 1 if dev.type == "cpu" else 0},
                             d, timeout=1200)
        secs = min(rep[0]["cases"]["op"]["samples"])
        # encode emits an n = 2k codeword from [k, lanes]; decode consumes
        # one; the NTT ops transform [k, lanes]
        factor = 2 if op in ("encode", "decode") else 1
        gbps = factor * k * lanes * 4 / secs / 1e9
        eff = 1.0 if base is None else gbps / (base * d)
        base = base or gbps
        print(json.dumps({"devices": d, "lanes": lanes,
                          "seconds": round(secs, 4),
                          "gb_per_sec": _sig6(gbps),
                          "weak_scaling_eff": round(eff, 3),
                          "virtual": _virtual(dev, d),
                          "backend": rep[0]["backend"],
                          "device": _device_name(dev)}))
        d *= 2
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="fastecc_tpu_torch",
        description="O(N log N) Reed-Solomon erasure coding on the GPU "
                    "(the PyTorch/CUDA port)")
    ap.add_argument("--field", default="GF32", choices=["GF32", "GF16",
                                                        "gf32", "gf16"])
    ap.add_argument("--device", default="cuda",
                    help="where to run (default the card; 'cpu' runs the "
                         "kernels' plain versions)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("verify", help="fast NTT vs naive DFT oracle")
    p.add_argument("--lg-n", type=int, default=8)
    p.add_argument("--lanes", type=int, default=4)
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("roundtrip", help="intt(ntt(x)) == x at scale")
    p.add_argument("--lg-n", type=int, default=16)
    p.add_argument("--lanes", type=int, default=4)
    p.set_defaults(fn=cmd_roundtrip)

    from .kernels.microbench import _VARIANTS
    p = sub.add_parser("gf-bench", help="mulmod microbenchmark")
    p.add_argument("--lg-size", type=int, default=24)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--variant", default="torch",
                   choices=["torch", *_VARIANTS, "stream", "all"],
                   help="one chain variant, the copy (stream), or 'all': "
                        "the measured peaks table")
    p.set_defaults(fn=cmd_gf_bench)

    p = sub.add_parser("ntt-bench", help="NTT throughput")
    p.add_argument("--lg-n", type=int, default=20)
    p.add_argument("--lanes", type=int, default=512)
    p.add_argument("--inverse", action="store_true")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--algo", default="auto",
                   choices=["auto", "stockham", "fourstep", "pallas"],
                   help="algorithm variant (reference `ntt` selector; "
                        "pallas = the fused two-pass kernels)")
    p.add_argument("--radix", type=int, default=4, choices=[2, 4])
    p.set_defaults(fn=cmd_ntt_bench)

    p = sub.add_parser("rs-bench", help="RS encode throughput")
    p.add_argument("--lg-k", type=int, default=19)
    p.add_argument("--lanes", type=int, default=1024)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--seam", default="auto", choices=["auto", "on", "off"],
                   help="A/B the three-pass pair vs the staged transforms "
                        "(auto = production dispatch)")
    p.add_argument("--pair-c-dim", type=int, default=None,
                   help="refused: the pair's split is the port's own "
                        "policy")
    p.set_defaults(fn=cmd_rs_bench)

    p = sub.add_parser("decode-bench", help="erasure decode throughput")
    p.add_argument("--lg-n", type=int, default=13)
    p.add_argument("--lg-e", type=int, default=12)
    p.add_argument("--lanes", type=int, default=1024)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device-locator", action="store_true",
                   help="build the locator on the device inside each "
                        "decode instead of the prepared tables")
    p.add_argument("--seam", default="auto", choices=["auto", "off"],
                   help="off runs the staged transforms in place of the "
                        "three-pass pair on the identical call path")
    p.set_defaults(fn=cmd_decode_bench)

    p = sub.add_parser("encode", help="encode a file into data+parity blocks")
    p.add_argument("file")
    p.add_argument("-o", "--out", required=True, help="output directory")
    p.add_argument("--block-bytes", type=int, default=4096,
                   help="wire block size (reference `rs` SIZE arg); "
                        "multiple of 4 for GF32, 2 for GF16")
    p.add_argument("--max-resident", type=int, default=2048, metavar="MB",
                   help="stream files larger than this through np.memmap "
                        "lane chunks instead of loading them whole")
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("recover", help="recover a file from survivors")
    p.add_argument("dir")
    p.add_argument("-o", "--out", required=True, help="recovered file path")
    p.add_argument("--max-resident", type=int, default=2048, metavar="MB",
                   help="stream codewords larger than this (memmap "
                        "staging + lane-chunk decode)")
    p.add_argument("--check", action="store_true",
                   help="verify the decoded codeword algebraically and "
                        "correct silently corrupted survivors "
                        "(errors-and-erasures, e + 2t <= n-k)")
    p.set_defaults(fn=cmd_recover)

    p = sub.add_parser("check", help="audit a coded directory (CRC + "
                                     "algebraic consistency)")
    p.add_argument("dir")
    p.add_argument("--max-resident", type=int, default=2048, metavar="MB",
                   help="stream codewords larger than this (memmap "
                        "staging + lane-chunk verification)")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("repair", help="regenerate missing block files "
                                      "(back to full n-of-n redundancy)")
    p.add_argument("dir")
    p.add_argument("--max-resident", type=int, default=2048, metavar="MB",
                   help="stream codewords larger than this (memmap "
                        "staging + lane-chunk decode)")
    p.set_defaults(fn=cmd_repair)

    p = sub.add_parser("read", help="ranged read from a coded directory "
                                    "(degraded reads decode only the "
                                    "touched column window)")
    p.add_argument("dir")
    p.add_argument("--offset", type=int, required=True)
    p.add_argument("--length", type=int, required=True)
    p.add_argument("-o", "--out", default=None,
                   help="output file (default: stdout)")
    p.set_defaults(fn=cmd_read)

    p = sub.add_parser("update", help="splice changed bytes into a "
                                      "coded directory (incremental "
                                      "parity update, no re-encode)")
    p.add_argument("dir")
    p.add_argument("file", help="file holding the new bytes")
    p.add_argument("--offset", type=int, required=True,
                   help="byte offset of the edit in the encoded payload "
                        "(the file size cannot change)")
    p.set_defaults(fn=cmd_update)

    p = sub.add_parser("roofline", help="speed-of-light bound for a "
                                        "pipeline config")
    p.add_argument("--pipeline", default="encode",
                   choices=["encode", "decode", "ntt", "encode-wire",
                            "decode-wire"])
    p.add_argument("--lg-n", type=int, default=20,
                   help="log2 of total codeword blocks (encode/decode) "
                        "or transform points (ntt)")
    p.add_argument("--lanes", type=int, default=1024)
    p.add_argument("--block-bytes", type=int, default=4096,
                   help="wire block size for the *-wire pipelines")
    p.add_argument("--seam", default="on", choices=["on", "off"],
                   help="price the 3-pass seam pair vs the 4 staged "
                        "passes (ignored for ntt)")
    p.add_argument("--peaks-json", default=None, metavar="FILE",
                   help="measured peaks (`gf-bench --variant all` JSON) "
                        "instead of the published H100 rates")
    p.set_defaults(fn=cmd_roofline)

    p = sub.add_parser("scaling", help="weak-scaling sweep over worlds "
                                       "of ranks (the sharded codec)")
    p.add_argument("--devices", type=int, default=8,
                   help="largest world: d = 1, 2, 4, ... ranks")
    p.add_argument("--lg-k", type=int, default=10)
    p.add_argument("--lanes", type=int, default=8,
                   help="lanes a rank (the world's data is [k, lanes * d])")
    p.add_argument("--iters", type=int, default=2)
    p.add_argument("--op", default="encode",
                   choices=["encode", "decode", "ntt", "ntt-overlap"],
                   help="pipeline under test (decode = sharded erasure "
                        "decode at max loss; ntt-overlap = the exchanges "
                        "overlapped with the local transforms)")
    p.add_argument("--overlap-chunks", type=int, default=2)
    p.add_argument("--procs", type=int, default=1,
                   help="structural row: this many ranks over a 2x2 (4) "
                        "or Nx1 mesh instead of the sweep")
    p.add_argument("--update-baseline", action="store_true",
                   help="append the --procs row to --baseline-path "
                        "(virtual-tagged)")
    p.add_argument("--baseline-path", default="BASELINE.md")
    p.set_defaults(fn=cmd_scaling)

    args = ap.parse_args(argv)
    if getattr(args, "pair_c_dim", None) is not None:
        ap.error("--pair-c-dim has no counterpart in the port: the pair's "
                 "four-step split is the port's own policy "
                 "(kernels.ntt_mfa._pair_split)")
    from .interop import resolve_device
    return args.fn(args, resolve_device(args.device))


if __name__ == "__main__":
    sys.exit(main())
