"""Run one cell several times, one process at a time, and print each
metric's spread: how the bounds in BENCHMARK.json are measured.

    python -m ecbench.sets --workload <name> --seconds <s> --seeds <n> ... \
        [--sets 2] [--trace 0] [--out <file.jsonl>]

Each set runs every seed once, in order; the sets repeat the same seeds.
A spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values: list) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "ecbench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.perf_counter() - t
    lines = p.stdout.strip().splitlines()
    result = None
    if p.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"seed": seed, "rc": p.returncode, "wall_s": wall,
            "result": result, "stderr": p.stderr[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = []
    for s in range(args.sets):
        for seed in args.seeds:
            r = run_once(args.workload, seed, args.seconds, args.trace)
            r["set"] = s
            runs.append(r)
            res = r["result"] or {}
            print(json.dumps({"set": s, "seed": seed, "rc": r["rc"],
                              "wall_s": round(r["wall_s"], 1),
                              "correct": res.get("correct"),
                              "metrics": {k: v["value"] for k, v in
                                          res.get("metrics", {}).items()}}),
                  flush=True)
            if r["rc"] != 0 or not res.get("correct"):
                print(r["stderr"], file=sys.stderr, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps({"workload": args.workload, **r}) + "\n")
    ok = [r for r in runs if r["result"]]
    names = sorted({k for r in ok for k in r["result"]["metrics"]})
    for name in names:
        per_set = []
        for s in range(args.sets):
            vals = [r["result"]["metrics"][name]["value"] for r in ok
                    if r["set"] == s and name in r["result"]["metrics"]]
            if len(vals) >= 2:
                per_set.append((statistics.median(vals), spread(vals)))
        print(f"{args.workload} {name}: " + "; ".join(
            f"set {i}: median {m!r}, spread {sp!r}"
            for i, (m, sp) in enumerate(per_set)), flush=True)
    bad = [r["seed"] for r in runs if not (r["result"] or {}).get("correct")]
    print(f"{args.workload}: {len(runs) - len(bad)} of {len(runs)} runs "
          f"correct; not correct: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
