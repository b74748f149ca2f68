"""The port's roofline model (``fastecc_tpu_torch.utils.profiling``) and
its command line (``fastecc_tpu_torch.cli``) against the JAX package's:
under the same peaks dict every roofline function gives the reference's
memory term, byte count and output keys; the compute terms are the port's
own op table priced by hand; and the two commands print the reference's
JSON keys.
"""

import json
import math

import pytest
import torch

from fastecc_tpu import cli as ref_cli
from fastecc_tpu.utils import profiling as ref
from fastecc_tpu_torch import cli
from fastecc_tpu_torch.kernels import microbench as mb
from fastecc_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)

PEAKS = {"published": prof.H100_PUBLISHED_PEAKS,
         "v5e": ref.MEASURED_PEAKS_V5E}

# (function, args, kwargs): tests/test_cli.py's configs among them
CONFIGS = [
    ("encode_roofline", (1 << 20, 1024), {"seam": False}),
    ("encode_roofline", (1 << 20, 1024), {}),
    ("encode_roofline", (1 << 14, 32768), {"field_name": "GF16",
                                           "seam": False}),
    ("encode_roofline", (1 << 14, 32768), {"field_name": "GF16"}),
    ("ntt_roofline", (1 << 20, 512), {}),
    ("ntt_roofline", (1 << 16, 64), {"field_name": "GF16"}),
    ("decode_roofline", (1 << 20, 512), {"seam": False}),
    ("decode_roofline", (1 << 13, 1024), {}),
    ("encode_blocks_roofline", (1 << 14, 65536), {}),
    ("encode_blocks_roofline", (1 << 14, 4096), {"fused": False}),
    ("encode_blocks_roofline", (1 << 14, 4096), {"field_name": "GF32",
                                                 "fused": False}),
    ("decode_blocks_roofline", (1 << 18, 4096), {"field_name": "GF32"}),
    ("decode_blocks_roofline", (1 << 15, 8192), {}),
    ("pipeline_roofline", ("GF32", 1 << 12, 8), {"hbm_passes": 2.5,
                                                 "out_bytes": 1000,
                                                 "extra_vpu_ops_per_elem":
                                                 1.5}),
]


@pytest.mark.parametrize("peaks", list(PEAKS))
@pytest.mark.parametrize("name,args,kw", CONFIGS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONFIGS)])
def test_roofline_memory_terms_match_reference(name, args, kw, peaks):
    got = getattr(prof, name)(*args, peaks=PEAKS[peaks], **kw)
    want = getattr(ref, name)(*args, peaks=PEAKS[peaks], **kw)
    assert set(got) == set(want)
    assert got["t_memory_bound_s"] == want["t_memory_bound_s"]
    for key in ("hbm_bytes", "fused"):
        assert got.get(key) == want.get(key)
    assert got["speed_of_light_s"] == max(got["t_memory_bound_s"],
                                          got["t_compute_bound_s"])


def test_compute_terms_are_the_port_op_table():
    """The GF32 rate-1/2 encode at 2^20 x 1024 under the published peaks,
    priced by hand: per element-stage 4 mulmods (the Solinas REDC: 1
    IMAD.WIDE, 7 other ops) + 4 adds (4) + 4 subs (3) per 8
    element-stages, 2 x 19 stages, plus 3 extra mulmods per element."""
    r = prof.encode_roofline(1 << 20, 1024)
    elems, rate = (1 << 19) * 1024, 132 * 64 * 1.98e9
    stage = elems * 2 * 19 * ((4 * 1) / 8 + (4 * 7 + 4 * 4 + 4 * 3) / 8)
    extra = elems * 3 * (1 + 7)
    assert math.isclose(r["t_stage_compute_s"], stage / rate, rel_tol=1e-12)
    assert math.isclose(r["t_extra_mulmod_s"], extra / rate, rel_tol=1e-12)
    assert r["bound"] == "compute"
    g = prof.encode_blocks_roofline(1 << 14, 65536)
    elems16 = (1 << 13) * 32768
    stage16 = elems16 * 2 * 13 * ((4 * 1) / 8 + (4 * 5 + 4 * 3 + 4 * 3) / 8)
    extra16 = elems16 * (3 * (1 + 10) + 6.0)
    assert math.isclose(g["t_compute_bound_s"], (stage16 + extra16) / rate,
                        rel_tol=1e-12)


def test_gf32_wire_has_no_fused_form():
    with pytest.raises(ValueError, match="no fused variant"):
        prof.encode_blocks_roofline(1 << 10, 4096, field_name="GF32")


def _row(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip())


@pytest.mark.parametrize("argv", [
    ["roofline", "--pipeline", "encode", "--lg-n", "20", "--lanes", "1024",
     "--seam", "off"],
    ["roofline", "--pipeline", "ntt", "--lg-n", "20", "--lanes", "512"],
    ["roofline", "--pipeline", "decode", "--lg-n", "20", "--lanes", "512"],
    ["--field", "gf16", "roofline", "--pipeline", "encode", "--lg-n", "14",
     "--lanes", "32768"],
    ["--field", "gf16", "roofline", "--pipeline", "encode-wire", "--lg-n",
     "14", "--block-bytes", "65536"],
    ["roofline", "--pipeline", "decode-wire", "--lg-n", "18"],
])
def test_cli_roofline_prints_reference_keys(argv, capsys, tmp_path):
    """Same peaks file for both: the same keys, memory term and bytes."""
    pf = tmp_path / "peaks.json"
    pf.write_text(json.dumps({"op": "gf_peaks", **ref.MEASURED_PEAKS_V5E}))
    want = _row(ref_cli.main, argv + ["--peaks-json", str(pf)], capsys)
    got = _row(cli.main, ["--device", "cpu", *argv, "--peaks-json",
                          str(pf)], capsys)
    assert set(got) == set(want)
    for key in ("op", "pipeline", "field", "lg_n", "lanes", "seam",
                "t_memory_bound_s", "hbm_bytes", "fused"):
        assert got.get(key) == want.get(key), key


def test_cli_roofline_default_peaks_are_the_published_rates(capsys):
    r = _row(cli.main, ["--device", "cpu", "roofline", "--pipeline", "ntt",
                        "--lg-n", "20", "--lanes", "512"], capsys)
    assert r["t_memory_bound_s"] == round(
        2 * 2 * (1 << 20) * 512 * 4 / 3.35e12, 6)


def test_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    for argv in (["roofline"], ["gf-bench", "--variant", "all"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)


@pytest.fixture
def small_sizes(monkeypatch):
    """The measurements at tiny sizes (the CPU runs the plain versions)."""
    hbm, chain, fused = (mb.hbm_stream_gbps, mb.vpu_chain_gops,
                         mb.fused_stage_gops)
    monkeypatch.setattr(mb, "hbm_stream_gbps", lambda mib=1024, iters=3,
                        device=None: hbm(mib=1, iters=1, device=device))
    monkeypatch.setattr(mb, "vpu_chain_gops", lambda v, mib=64, depth=None,
                        iters=3, device=None: chain(v, mib=1, depth=1,
                                                    iters=1, device=device))
    monkeypatch.setattr(mb, "fused_stage_gops", lambda field_name="GF32",
                        c=2048, rows_tiles=64, depth=2, iters=3, device=None:
                        fused(field_name, c=min(c, 16), rows_tiles=1,
                              depth=1, iters=1, device=device))


@pytest.mark.parametrize("variant,op", [("all", "gf_peaks"),
                                        ("stream", "hbm_stream"),
                                        ("stage-r4", "gf_chain"),
                                        ("torch", "gf_mul")])
def test_cli_gf_bench_dispatch_on_cpu(variant, op, small_sizes, capsys):
    r = _row(cli.main, ["--device", "cpu", "gf-bench", "--variant", variant,
                        "--iters", "1", "--lg-size", "10"], capsys)
    assert r["op"] == op and r["device"] == "cpu"
    if op == "gf_peaks":
        assert set(r) - {"op", "device"} == (
            {mb.peak_key(v) for v in mb._VARIANTS} | {"hbm_stream_gbps"}
            | set(mb._FUSED_CONFIGS))
    elif op == "gf_chain":
        assert r["variant"] == variant and "gops" in r
    elif op == "hbm_stream":
        assert "gb_per_sec" in r
    else:
        assert r["elements"] == 1 << 10 and r["unit"] == "Gmul/s"
