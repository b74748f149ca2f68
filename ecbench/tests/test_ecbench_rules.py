"""BENCHMARK.json against its rules, the harness's imports, the byte counts
of the roofline readers, and the runner's refusal to measure without a
card. CPU only."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from ecbench import bench, ops

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX = {"jax", "jaxlib", "flax", "fastecc_tpu"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def _imports(path: Path) -> set:
    """Top-level names of every absolute import in a module."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert "fastecc_tpu_torch" not in names and "ecbench" not in names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            assert node.level == 0, "the reference stands alone"


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["ecbench"]
    assert 1 <= len(SPEC["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        for e in SPEC[group]:
            assert set(e) <= keys and keys - set(e) <= {"workloads"}, e
            assert NAME.match(e["name"]) and e["name"] not in seen, e
            seen.add(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k], e
            if "unit" in e:
                assert UNIT.match(e["unit"]), e
                assert e["better"] in ("lower", "higher")
            for c in e.get("workloads", []):
                assert c in CELLS, e


def test_cells_are_one_chip_and_find_their_files():
    pairs = set()
    for w in SPEC["workloads"]:
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = bench.cell(w["name"])
        assert cell.config["field"] in ("GF32", "GF16")
        assert cell.traffic["op"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for c in SPEC["configs"]:
        assert c["file"].startswith("ecbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] == []


def test_every_metric_has_a_reader_and_moves_a_reported_metric():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for c in m["workloads"]:
            assert bench.reports(moved, c), (m["name"], c)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25
    assert {m["source"] for m in SPEC["per_layer"]} <= {
        "device_trace", "program_span", "program_counter", "host_clock"}
    assert all(m["name"].endswith("_roofline") for m in SPEC["per_layer"]
               if m["unit"] == "%" and "roofline" in m["name"])


def _op(name):
    cell = bench.cell(name)
    return ops.make(cell.config, cell.traffic, 1, "cpu")


def test_operation_bytes_match_the_hand_counts():
    # 2 GiB of data read plus 2 GiB of parity written
    assert _op("gf32_n1m.encode").operation_bytes() == 2 * 2 ** 31
    # 512 MiB of raw blocks read, 2^13 wire parity blocks written
    assert _op("gf16_n16k.encode").operation_bytes() == 2 ** 29 + 2 ** 13 * (
        65536 + 4096)
    # 2^19 surviving rows read, 2^19 lost rows written
    assert _op("gf32_n1m.repair").operation_bytes() == 2 ** 19 * 4096 * 2


def test_operation_multiplies_match_the_hand_counts():
    # radix-2, only w^0 free: N/2 log2 N - (N - 1)
    assert ops.transform_multiplies(2 ** 19, 2) == 2 ** 18 * 19 - 2 ** 19 + 1
    # GF16: the 5 stages of 32nd roots free, 32 - 16 = 16 of the first
    # paid stage's 32 roots, 64 - 16 of the next ...
    assert ops.transform_multiplies(2 ** 13, 32) == sum(
        2 ** 13 // (2 * h) * (h - 16) for h in (2 ** j for j in range(5, 13)))
    # two transforms of k = 2^19 and the coset's k multiplies, 1024 lanes
    t19 = 2 ** 18 * 19 - 2 ** 19 + 1
    assert _op("gf32_n1m.encode").operation_multiplies() == 1024 * (
        2 * t19 + 2 ** 19)
    # two transforms of n = 2^20 and 2n multiplies, 1024 lanes
    t20 = 2 ** 19 * 20 - 2 ** 20 + 1
    assert _op("gf32_n1m.repair").operation_multiplies() == 1024 * (
        2 * t20 + 2 ** 21)


def test_which_bound_binds():
    # the encodes are bound by their bytes, the repair by its multiplies
    for name, binds, ms in (("gf32_n1m.encode", "bytes", 1.2821),
                            ("gf16_n16k.encode", "bytes", 0.3305),
                            ("gf32_n1m.repair", "operations", 2.5642)):
        least = _op(name).least_s()
        assert max(least, key=least.get) == binds
        assert 1e3 * least[binds] == pytest.approx(ms, abs=1e-4)


def test_every_mix_finds_its_operation():
    for path in sorted((HERE / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        module = ops.module(mix["op"])
        assert issubclass(module.Op, ops.Operation), path.name
        assert module.CONTROL, path.name
    with pytest.raises(ValueError):
        ops.module("../run")


def _run(cwd, workload="gf32_n1m.encode"):
    return subprocess.run(
        [sys.executable, "-m", "ecbench.run", "--workload", workload,
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_runner_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no result without a card" in p.stderr


def test_runner_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "ecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
