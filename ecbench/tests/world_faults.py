"""Helpers of ``test_ecbench_world.py``: a temporary ``BENCHMARK.json``
whose one cell runs ``encode_sharded`` on four ranks at a size the CPU
holds, the faults the tests plant in the ranks' processes, and a command
that runs that cell on the CPU in a process of its own:

    python ecbench/tests/world_faults.py <spec> <seed> [<fault> <rank>]

It prints the result line as ``ecbench.run`` does; a fault given with
rank -1 goes into every rank; with ``hang_at_3`` a step of the window and
the program's collectives have HANG_LIMIT_S, not ``world.CALL_LIMIT_S``.
The spec names, of the benchmark's files, only what a four-card cell
adds (the mix ``encode_sharded`` and its operation) and readers every
cell has; its configuration is a file of its own beside it.
"""

from __future__ import annotations

import json
import sys
import time
import types
from pathlib import Path

import torch

from ecbench import bench, run, world
from ecbench.ops import encode_sharded
from fastecc_tpu_torch.parallel import ntt_dist

CELL = "gf32_n1k_x4.encode"
CONFIG = {"name": "gf32_n1k_x4", "field": "GF32", "p": 0xFFF00001,
          "n": 1 << 10, "k": 1 << 9, "block_bytes": 64,
          "reduced": ["n", "k", "block_bytes"]}
# A fake peak a rank reports, so the line's can be told from rank 0's
PEAK = 10 ** 9
# The deadline of a step of the window in a run with a hanging rank
HANG_LIMIT_S = 5.0


def write_spec(tmp: Path) -> Path:
    """A ``BENCHMARK.json`` in ``tmp`` holding the one four-chip cell."""
    config = tmp / f"{CONFIG['name']}.json"
    config.write_text(json.dumps(CONFIG))
    metric = {"better": "higher", "source": "host_clock",
              "workloads": [CELL]}
    spec = {
        "command": ["python3", "-m", "ecbench.run"], "paths": ["ecbench"],
        "run_seconds": 1,
        "configs": [{"name": CONFIG["name"], "source": "a test",
                     "file": str(config), "reduced": CONFIG["reduced"],
                     "why": "the sharded encode at a size the CPU holds"}],
        "workloads": [{"name": CELL, "config": CONFIG["name"],
                       "traffic": "encode_sharded", "chips": 4,
                       "why": "four ranks over Gloo on the CPU"}],
        "end_to_end": [
            {"name": "encode_GBps", "unit": "GB/s", "bound": 0.25, **metric},
            {"name": "encode_p95_ms", "unit": "ms", "bound": 0.25,
             **metric, "better": "lower"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": "device_idle_pct.encode", "unit": "%",
                       "better": "lower", "source": "device_trace",
                       "layer": "device", "moves": "encode_GBps",
                       "workloads": [CELL]}]}
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path


def cell(spec: Path) -> bench.Cell:
    return bench.cell(CELL, spec)


class _Done:
    def wait(self):
        return True


def _no_exchange(recv, send, group=None, async_op=False):
    """An all-to-all that sends nothing: each rank keeps its own parts."""
    recv.copy_(send)
    return _Done() if async_op else None


def _wrap(change):
    real = ntt_dist.encode_parity_sharded

    def broken(data, *args, **kwargs):
        return change(real, data, *args, **kwargs)
    return broken


def _altered(real, data, *args, **kwargs):
    """One word of the answer changed where it is produced."""
    out = real(data, *args, **kwargs).clone()
    out.view(torch.uint8).view(-1)[-1] ^= 1
    return out


def _left_out(real, data, *args, **kwargs):
    """This rank's shard left out of the encode: zeros in its place."""
    return real(torch.zeros_like(data), *args, **kwargs)


def _handed_back(real, data, *args, **kwargs):
    """The step hands back its input unchanged."""
    return data.clone()


def _at_3(call, what):
    """The window's call 3 raises, or never returns."""
    def broken(self, i, slot):
        if i == 3 and what == "raise":
            raise RuntimeError("planted: call 3 fails")
        while i == 3:
            time.sleep(1)
        return call(self, i, slot)
    return broken


def patches(fault: str, rank: int = 0) -> list:
    """(object, attribute, value) triples that plant ``fault`` in rank
    ``rank``'s process."""
    if fault == "altered":
        return [(ntt_dist, "encode_parity_sharded", _wrap(_altered))]
    if fault == "left_out":
        return [(ntt_dist, "encode_parity_sharded", _wrap(_left_out))]
    if fault == "handed_back":
        return [(ntt_dist, "encode_parity_sharded", _wrap(_handed_back))]
    if fault == "no_exchange":
        return [(ntt_dist, "dist",
                 types.SimpleNamespace(all_to_all_single=_no_exchange))]
    if fault in ("raise_at_3", "hang_at_3"):
        return [(world.Rank, "call", _at_3(world.Rank.call, fault[:-5]))]
    if fault == "jax":
        return [(sys.modules, "jax", types.ModuleType("jax"))]
    if fault == "peak":
        return [(world, "peak_bytes", lambda device: PEAK + rank)]
    if fault == "control":
        return list(encode_sharded.CONTROL)
    raise ValueError(fault)


def plant(fault: str | None, target: int, rank: int) -> None:
    """``run_cell``'s ``rank_init``: one thread a rank, and ``fault`` in
    rank ``target``'s process (every rank's where ``target`` is -1)."""
    torch.set_num_threads(1)
    if fault is None or target not in (rank, -1):
        return
    for obj, name, value in patches(fault, rank):
        if isinstance(obj, dict):
            obj[name] = value
        else:
            setattr(obj, name, value)


def run_cell(spec: Path, seed: int, fault: str | None = None,
             target: int = 0) -> dict:
    """One run of the cell on the CPU, ``fault`` planted in rank
    ``target``'s process (in every other rank's where it is -1: the
    caller plants it in rank 0's)."""
    import functools
    return run.run_cell(cell(spec), seed, 0.5, False, device="cpu",
                        t_start=time.perf_counter(),
                        rank_init=functools.partial(plant, fault, target))


def main(argv) -> int:
    # the ranks find plant under the name they can import
    from ecbench.tests import world_faults as me
    spec, seed = Path(argv[0]), int(argv[1])
    fault, target = (argv[2], int(argv[3])) if len(argv) > 2 else (None, 0)
    if target in (-1, 0):
        me.plant(fault, target, 0)
    if fault == "hang_at_3":
        world.CALL_LIMIT_S = HANG_LIMIT_S
    print(json.dumps(me.run_cell(spec, seed, fault, target)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
