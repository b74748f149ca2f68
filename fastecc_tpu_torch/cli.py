"""Command-line interface of the port: the counterpart of ``cli.py``.

    python -m fastecc_tpu_torch.cli gf-bench --variant all   # the card's peaks
    python -m fastecc_tpu_torch.cli gf-bench --variant solinas
    python -m fastecc_tpu_torch.cli roofline --pipeline encode --lg-n 20

``gf-bench`` runs the microbenchmark kernels (K13 copy, K14 chains, K15
fused chains) and prints the reference's JSON lines (``op``: ``gf_peaks``,
``hbm_stream``, ``gf_chain``; ``--variant torch`` times ``gf.mul`` as
framework ops, ``gf_mul``), each naming the device it ran on. ``roofline``
prints a pipeline's speed-of-light bound (``op``: ``roofline``) from the
published H100 peaks, or from a ``gf-bench --variant all`` line given as
``--peaks-json``. Both run on the card unless ``--device cpu``; without a
GPU they raise. The reference's other commands are still to be ported.
"""

from __future__ import annotations

import argparse
import json
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

    from .kernels.microbench import _VARIANTS
    p = sub.add_parser("gf-bench", help="mulmod microbenchmark")
    p.add_argument("--lg-size", type=int, default=24)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--variant", default="torch",
                   choices=["torch", *_VARIANTS, "stream", "all"],
                   help="one chain variant, the copy (stream), or 'all': "
                        "the measured peaks table")
    p.set_defaults(fn=cmd_gf_bench)

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

    args = ap.parse_args(argv)
    from .interop import resolve_device
    return args.fn(args, resolve_device(args.device))


if __name__ == "__main__":
    sys.exit(main())
