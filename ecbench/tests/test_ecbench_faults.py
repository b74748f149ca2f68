"""Whole runs of every cell at a size the CPU holds, past the harness's
look for a card: a sound program comes out correct, and the control and
each fault planted under the timed path come out not correct."""

import time

import pytest
import torch

from ecbench import bench, control, run
from fastecc_tpu_torch import decode, rs

SMALL = {"gf32_n1m": dict(n=128, k=64, block_bytes=64),
         "gf16_n16k": dict(n=64, k=32, block_bytes=512)}
CELLS = [w["name"] for w in bench.load_json(bench.BENCHMARK)["workloads"]]
# the program entry each operation's calls drive
ENTRY = {"encode": (rs, "encode_parity"),
         "encode_blocks": (rs, "encode_blocks"),
         "decode": (decode, "decode_prepared")}


def _cell(name: str) -> bench.Cell:
    return bench.cell(name)


def _run(name: str, seed: int = 2 ** 31 + 11) -> dict:
    cell = _cell(name)
    cell.config.update(SMALL[cell.config["name"]])
    return run.run_cell(cell, seed, 0.2, False, device="cpu",
                        t_start=time.perf_counter())


def _altered(out, inputs):
    """One word of the answer changed where it is produced."""
    out = out.clone()
    flat = out.view(torch.uint8).view(-1)
    flat[-1] ^= 1
    return out


def _half_left_out(out, inputs):
    """The second half of the lanes never computed: left as they came in
    (the decode's garbage) or zero."""
    out = out.clone()
    half = out.shape[1] // 2
    src = inputs[0]
    if src.shape == out.shape:
        out[:, half:] = src[:, half:]
    else:
        out[:, half:] = 0
    return out


def _unchanged(out, inputs):
    """The step hands back its input unchanged."""
    return inputs[0].clone()


FAULTS = {"altered": _altered, "half_left_out": _half_left_out,
          "unchanged": _unchanged}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = _run(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["checks"]["judged_outputs"]["value"] >= 1
    assert list(line)[-1] == "checks"
    reported = {m["name"] for m in _cell(name).end_to_end}
    assert set(line["metrics"]) == reported
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    with control.in_place(_cell(name).traffic["op"]):
        line = _run(name)
    assert not line["correct"]
    assert line["checks"]["bad_words"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    module, entry = ENTRY[_cell(name).traffic["op"]]
    real = getattr(module, entry)

    def broken(*args, **kwargs):
        return FAULTS[fault](real(*args, **kwargs), args)
    monkeypatch.setattr(module, entry, broken)
    line = _run(name)
    assert not line["correct"]
    assert line["failed"] >= 1
