"""Run one cell of the benchmark once and print its result line.

    python -m ecbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs on the card from the seed and warms every
shape the cell uses. The window is a closed loop with one client: a call
into the program, a fence (``torch.cuda.synchronize``), and the next call
right after, for ``--seconds``. After the window the program's state is
freed and the plain reference judges the outputs of calls sampled from
the seed. The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from the profiler's trace of the window's last
part and from the harness's own clock around each program entry.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from . import bench  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fastecc_tpu")
PROFILED_S = 2.0        # the traced part of the window, at most
PROFILED_CALLS = 2      # at least
# Calls run under the profiler before the traced part opens: the tracer
# can lose the card's records of a started session's first calls (the
# first 10-24 ms of a session in 51 s runs on an H100).
TRACER_WARMUP_S = 0.25


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Call:
    start: float
    end: float           # after the fence
    entries: list        # (name, start, returned, fenced) per entry
    profiled: bool


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: bench.Cell
    op: object
    setup_s: float
    window_s: float
    calls: list
    trace: object        # trace.Trace of a traced run, else None

    def codeword_GBps(self) -> float:
        """Codeword bytes of every call over the whole window."""
        return len(self.calls) * self.op.codeword_bytes / self.window_s / 1e9

    def call_quantile_ms(self, q: float) -> float:
        """The q-quantile of every call's fenced time, in ms."""
        times = [1e3 * (c.end - c.start) for c in self.calls]
        if len(times) < 2:
            return times[0]
        return statistics.quantiles(times, n=100,
                                    method="inclusive")[round(100 * q) - 1]

    def entry_ms(self, prefix: str):
        """Mean host time from the call into each program entry named
        ``prefix...`` to its return, before the fence, over the calls
        the profiler did not see. None outside a traced run."""
        if self.trace is None:
            return None
        t = [ret - s for c in self.calls if not c.profiled
             for name, s, ret, _ in c.entries if name.startswith(prefix)]
        return 1e3 * sum(t) / len(t) if t else None

    def call_busy_s(self):
        """Mean device-busy seconds a profiled call."""
        if self.trace is None:
            return None
        calls = self.trace.calls()
        return sum(self.trace.busy_ns(s, e) for s, e in calls) / len(
            calls) / 1e9

    def roofline_pct(self):
        """The least time a call takes on the card, by the larger of its
        bytes and its operations bounds (the operation's ``least_s``),
        over a profiled call's device-busy time, in %."""
        busy = self.call_busy_s()
        if not busy:
            return None
        least = self.op.least_s()
        binds = max(least, key=least.get)
        say(f"roofline: bytes {1e3 * least['bytes']:.4f} ms, operations "
            f"{1e3 * least['operations']:.4f} ms a call, {binds} bind; "
            f"device busy {1e3 * busy:.4f} ms a call")
        return 100.0 * least[binds] / busy

    def idle_pct(self):
        """The card's idle share of the profiled part of the window: 1 -
        the union of its kernels, copies and fills over it, in %."""
        if self.trace is None:
            return None
        lo, hi = self.trace.window()
        return 100.0 * (1.0 - self.trace.busy_ns(lo, hi) / (hi - lo))


class Entry:
    """Runs one program entry for the operation: times it on the host and,
    in a traced run, wraps it in a span and fences it."""

    def __init__(self, sync, traced: bool):
        self.sync, self.traced = sync, traced
        self.entries: list = []
        self.names: set = set()

    def __call__(self, name, fn, *args, **kwargs):
        start = time.perf_counter()
        if not self.traced:
            out = fn(*args, **kwargs)
            ret = fenced = time.perf_counter()
        else:
            from torch.profiler import record_function
            self.names.update((name, name + ":fence"))
            with record_function(name):
                out = fn(*args, **kwargs)
            ret = time.perf_counter()
            with record_function(name + ":fence"):
                self.sync()
            fenced = time.perf_counter()
        self.entries.append((name, start, ret, fenced))
        return out


def card_info() -> None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        say(f"card: {out}")
    except (OSError, subprocess.SubprocessError) as e:
        say(f"card: nvidia-smi unavailable ({e})")


def run_cell(cell: bench.Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float = T_START,
             marks: tuple = ()) -> dict:
    """One run of ``cell``; returns the result line's object. ``marks``
    are the (phase, time) ends of set-up's phases before the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import ops
    from . import trace as tr

    cuda = torch.device(device).type == "cuda"
    phases: list = list(marks)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def mark(phase: str, fence: bool = True) -> None:
        if fence:
            sync()
        phases.append((phase, time.perf_counter()))

    mark("program", fence=False)
    torch.zeros(1, device=device)
    mark("card")
    op = ops.make(cell.config, cell.traffic, seed, device)
    op.prepare()
    mark("inputs")
    entry = Entry(sync, traced)
    warm = max(2, cell.traffic.get("pool", 1))
    for i in range(warm):
        op.before(i)
        op.call(i, entry)
        sync()
    mark("warm-up")
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    if traced:
        # the tracer's first session can drop kernels: spend it here
        with profile(activities=activities):
            op.before(warm)
            op.call(warm, entry)
            sync()
        mark("profiler")

    setup_s = time.perf_counter() - t_start
    last = t_start
    for i, (phase, t) in enumerate(phases):
        phases[i], last = f"{phase} {t - last:.3f} s", t
    say(f"setup: {', '.join(phases)}")
    samples = cell.traffic["samples"]
    chooser = np.random.default_rng(ops.seed_state(seed, 4))
    kept: list = []
    calls: list = []
    prof = window = None
    profiled = 0
    profile_from = seconds - min(PROFILED_S + TRACER_WARMUP_S, seconds / 4)
    names = {tr.CALL, tr.WINDOW, "ecbench.before"}
    begin = time.perf_counter()
    i = 0
    while True:
        if traced:
            with record_function("ecbench.before"):
                op.before(i)
        else:
            op.before(i)
        entry.entries = []
        start = time.perf_counter()
        if traced:
            with record_function(tr.CALL):
                out = op.call(i, entry)
                sync()
        else:
            out = op.call(i, entry)
            sync()
        end = time.perf_counter()
        calls.append(Call(start, end, entry.entries, prof is not None))
        profiled += window is not None
        # keep `samples` outputs, each call equally likely (reservoir)
        if len(kept) < samples:
            kept.append((i, out))
        else:
            j = int(chooser.integers(0, i + 1))
            if j < samples:
                kept[j] = (i, out)
        del out
        i += 1
        elapsed = end - begin
        if elapsed >= seconds and (prof is None or profiled >= PROFILED_CALLS):
            break
        if traced and prof is None and elapsed >= profile_from:
            prof = profile(activities=activities)
            prof.start()
            started = time.perf_counter()
        elif (prof is not None and window is None
              and time.perf_counter() - started >= min(
                  TRACER_WARMUP_S, seconds / 16)):
            window = record_function(tr.WINDOW)
            window.__enter__()
    window_s = calls[-1].end - begin
    trace = None
    if prof is not None:
        window.__exit__(None, None, None)
        prof.stop()
        trace = tr.collect(prof, names | entry.names)
        reason = trace.guard()
        if reason:
            raise RuntimeError(f"traced run unreadable: {reason}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    run = Run(cell, op, setup_s, window_s, calls, trace)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    say(f"window: {len(calls)} calls in {window_s:.3f} s, setup "
        f"{setup_s:.3f} s, p50 {run.call_quantile_ms(0.5):.4f} ms, "
        f"{profiled} profiled")

    # the program's state goes before the reference runs on the card
    op.release()
    if cuda:
        torch.cuda.empty_cache()
        card_info()
    t = time.perf_counter()
    bad = op.judge(kept)
    say(f"judged {len(kept)} outputs (calls {[i for i, _ in kept]}) in "
        f"{time.perf_counter() - t:.2f} s")
    checks = {"bad_words": {"value": sum(bad), "max": 0},
              "judged_outputs": {"value": len(kept), "min": 1}}
    for name, c in checks.items():
        limit = " ".join(f"{k} {v}" for k, v in c.items() if k != "value")
        say(f"check {name} {c['value']} {limit}")

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": sum(bad) == 0 and len(kept) >= 1,
            "attempted": len(calls), "failed": sum(1 for b in bad if b),
            "metrics": metrics, "device": dev}
    if trace is not None:
        lo, hi = trace.window()
        dev["busy_s"] = trace.busy_ns(lo, hi) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        line["breakdown"] = {"device_ops": trace.device_ops(),
                             "idle_gaps": trace.idle_gaps()}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = bench.cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"error: {args.workload} needs {cell.chips} CUDA device(s), "
            f"found {torch.cuda.device_count()}; no result without a card")
        return 2
    marks = (("torch", time.perf_counter()),)
    flags = {k: v for k, v in os.environ.items() if k.startswith("FASTECC_")}
    say(f"env FASTECC_*: {flags or 'none'}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    marks=marks)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        say(f"error: the process loaded {loaded}")
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
