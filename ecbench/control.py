"""The control: the plain reference put in the program's place, with
every product rounded to the nearest floating precision narrower than
the exact product (``reference.rs.Field(control=True)``). The
configurations state exact arithmetic mod p, so the judge has to find
the control's outputs wrong; this measures by how much.

    python -m ecbench.control --workload <name> --seconds <s> --seeds <n> ...

Each seed is one run of the cell (set-up, a window, the judge) with the
program's entries for the cell's operation replaced by the control that
the operation's module names (``ops/<op>.py``, ``CONTROL``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import traceback

import torch

from . import bench, ops, run


@contextlib.contextmanager
def in_place(op: str):
    """The control in the program's place for operation ``op``: the
    entries its module's ``CONTROL`` names."""
    replace = ops.module(op).CONTROL
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in replace]
    try:
        for mod, name, fn in replace:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_cell(cell: bench.Cell, seed: int, seconds: float, rank_init=None,
             **kwargs) -> dict:
    """One untraced run of ``cell`` (``run.run_cell``) with the control in
    the program's place in every rank; ``rank_init`` runs first in each
    rank but 0."""
    op = cell.traffic["op"]
    with in_place(op):
        return run.run_cell(cell, seed, seconds, False, rank_init=(
            functools.partial(ops.control_for_good, op, rank_init)),
            **kwargs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        run.say("error: the control is measured on the card")
        return 2
    for seed in args.seeds:
        try:
            line = run_cell(cell, seed, args.seconds)
        except Exception:
            # a control that crashes has failed; exit as ecbench.run does
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": line["correct"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
