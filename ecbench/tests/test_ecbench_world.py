"""The launcher of ranks: a cell of four chips run through ``run_cell`` as
four CPU processes over Gloo, from a temporary ``BENCHMARK.json``
(``world_faults.write_spec``). A sound run is correct; the control, each
fault planted in the ranks and a rank that loads JAX are not; a rank
that raises ends the run inside its deadline, with no result line and no
process left behind."""

import functools
import json
import os
import re
import subprocess
import sys
import time
import uuid
from pathlib import Path

import pytest

from ecbench import control, ops, peaks, world
from ecbench.tests import world_faults as wf

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 13


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return wf.write_spec(tmp_path_factory.mktemp("spec"))


def test_sound_run_is_correct(spec):
    line = wf.run_cell(spec, SEED)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["checks"]["judged_outputs"]["value"] == 2
    assert list(line)[-1] == "checks"
    assert line["device"]["count"] == 4
    assert set(line["metrics"]) == {"encode_GBps", "encode_p95_ms",
                                    "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())


def test_control_is_not_correct(spec):
    line = control.run_cell(wf.cell(spec), SEED, 0.5, device="cpu",
                            rank_init=functools.partial(wf.plant, None, 0))
    assert not line["correct"]
    assert line["checks"]["bad_words"]["value"] > 0


# fault -> the rank it is planted in (-1: every rank, rank 0 too)
FAULTS = {"altered": 2, "left_out": 2, "handed_back": -1, "no_exchange": -1}


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(spec, fault, monkeypatch):
    target = FAULTS[fault]
    if target == -1:
        for obj, name, value in wf.patches(fault):
            monkeypatch.setattr(obj, name, value)
    line = wf.run_cell(spec, SEED, fault, target)
    assert not line["correct"]
    assert line["failed"] >= 1


def test_a_rank_that_loads_jax_fails_the_run(spec):
    with pytest.raises(RuntimeError, match="forbidden"):
        wf.run_cell(spec, SEED, "jax", 3)


def test_memory_peak_is_the_ranks_largest(spec):
    line = wf.run_cell(spec, SEED, "peak", -1)
    assert line["correct"]
    assert line["device"]["memory_peak_bytes"] == wf.PEAK + 3


def _ours(tag: str) -> list:
    """Pids of live processes whose environment holds ``tag``."""
    found = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if tag.encode() in f.read():
                    found.append(int(pid))
        except (OSError, ValueError):
            pass
    return found


HANG_S = wf.HANG_LIMIT_S + world.GRACE_S + 30
# (fault, its rank) -> (the longest the run may take, what rank 0 says):
# rank 2 raises; rank 2 hangs, so the others' collectives time out or the
# deadline passes; rank 0 hangs in its own step, so the watchdog kills
# the others and ends rank 0's process
ENDINGS = {("raise_at_3", 2): (60, "planted: call 3 fails"),
           ("hang_at_3", 2): (HANG_S, "Timed out|passed its deadline"),
           ("hang_at_3", 0): (HANG_S, "did not return from step call")}


@pytest.mark.parametrize("fault,rank", ENDINGS)
def test_a_rank_that_fails_ends_the_run(spec, fault, rank):
    tag = uuid.uuid4().hex
    env = dict(os.environ, PYTHONPATH=str(ROOT), ECBENCH_TEST_TAG=tag)
    longest, said = ENDINGS[fault, rank]
    t = time.monotonic()
    p = subprocess.run(
        [sys.executable, str(Path(wf.__file__)), str(spec), str(SEED),
         fault, str(rank)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=world.CALL_LIMIT_S + 60)
    assert time.monotonic() - t < longest
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert re.search(said, p.stderr), p.stderr[-3000:]
    assert _ours(f"ECBENCH_TEST_TAG={tag}") == []


def _op(config, size=4):
    w = world.World(0, size, "unused", 1.0, "unused")
    return ops.make(config, {"op": "encode_sharded", "mesh": [4, 1],
                             "pool": 2, "samples": 2}, 1, "cpu", w)


def test_encode_sharded_counts_match_the_hand_counts():
    small = _op(wf.CONFIG)
    # a rank reads its 2^7 data blocks and writes its 2^7 parity blocks
    assert small.operation_bytes() == 256 * 64
    # two transforms, each sending 3/4 of the rank's 2^7 rows of 64 bytes
    assert small.link_bytes() == 2 * 3 * 2 ** 7 * 64 // 4
    # a quarter of the encode's multiplies: two transforms of 2^9 and the
    # coset's 2^9, 16 lanes
    t9 = 2 ** 8 * 9 - 2 ** 9 + 1
    assert small.operation_multiplies() == 16 * (2 * t9 + 2 ** 9) // 4
    # the proposed 4 x 1 stripe of 2^20 blocks of 32 KB
    big = _op({"field": "GF32", "n": 2 ** 20, "k": 2 ** 19,
               "block_bytes": 32768})
    assert big.operation_bytes() == 2 ** 18 * 32768          # 8 GiB
    assert big.link_bytes() == 2 * 3 * 2 ** 17 * 32768 // 4  # 6 GiB
    t19 = 2 ** 18 * 19 - 2 ** 19 + 1
    assert big.operation_multiplies() == 8192 * (2 * t19 + 2 ** 19) // 4
    least = big.least_s()
    assert least["link"] == pytest.approx(6 * 2 ** 30 / 450e9)
    assert max(least, key=least.get) == "link"
    assert peaks.LINK_BYTES_PER_S == 450e9


def test_encode_sharded_refuses_a_world_it_does_not_fit():
    with pytest.raises(ValueError):
        _op(wf.CONFIG, size=2)
    with pytest.raises(ValueError):
        ops.make(wf.CONFIG, {"op": "encode_sharded", "mesh": [4, 1],
                             "pool": 2, "samples": 2}, 1, "cpu")


def test_the_ranks_print_nothing_to_standard_output(spec):
    p = subprocess.run(
        [sys.executable, str(Path(wf.__file__)), str(spec), str(SEED)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["count"] == 4
    assert len(p.stdout.strip().splitlines()) == 1
