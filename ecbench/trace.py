"""The profiler's trace of a traced run, reduced to what the per-layer
readers need.

The harness opens ``record_function`` spans of its own around each call
(``ecbench.call``), each program entry it drives (named after the entry,
as ``rs.encode_parity``, and ``<entry>:fence`` for the wait after it),
the untimed set-up of a call (``ecbench.before``) and the profiled part
of the window (``ecbench.window``). The device side is every kernel,
copy and fill the card ran. Times are nanoseconds on the trace's clock.
"""

from __future__ import annotations

import dataclasses

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "ecbench.window"
CALL = "ecbench.call"
OUTSIDE = "ecbench.loop"         # the host between the harness's spans


@dataclasses.dataclass
class Trace:
    spans: list      # (name, start, end) host spans the harness opened
    device: list     # (name, kind, start, end) operations on the card

    def window(self):
        """(start, end) of the profiled part of the window."""
        found = [(s, e) for n, s, e in self.spans if n == WINDOW]
        return found[0] if found else None

    def calls(self):
        lo, hi = self.window()
        return [(s, e) for n, s, e in self.spans
                if n == CALL and lo <= s and e <= hi]

    def busy_ns(self, lo: int, hi: int) -> int:
        """Time in [lo, hi) during which the card ran something."""
        return sum(e - s for s, e in _union(self.device, lo, hi))

    def kernels_in(self, lo: int, hi: int) -> int:
        return sum(1 for _, kind, s, _ in self.device
                   if kind == "kernel" and lo <= s < hi)

    def guard(self) -> str | None:
        """Why this trace cannot be read, or None: it must hold the
        profiled window and a kernel inside every profiled call."""
        if self.window() is None:
            return "the trace holds no profiled window"
        calls = self.calls()
        if not calls:
            return "the trace holds no call inside the profiled window"
        empty = sum(1 for s, e in calls if self.kernels_in(s, e) == 0)
        if empty:
            return (f"{empty} of {len(calls)} profiled calls hold no kernel "
                    f"in the trace (the tracer lost the call's kernels)")
        return None

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the card's operations in the profiled
        window, summed by name, the largest first."""
        lo, hi = self.window()
        total: dict = {}
        for name, _, s, e in self.device:
            if lo <= s < hi:
                key = short_name(name)
                total[key] = total.get(key, 0) + (min(e, hi) - s)
        return [[k, v / 1e9] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host span, seconds]]: the card's idle time in the profiled
        window, summed by the innermost harness span the host was in at
        each gap's middle, the largest first."""
        lo, hi = self.window()
        inner = [(s, e, n) for n, s, e in self.spans if n != WINDOW]
        total: dict = {}
        cursor = lo
        for s, e in _union(self.device, lo, hi) + [(hi, hi)]:
            if s > cursor:
                mid = (cursor + s) // 2
                around = [(ss, n) for ss, ee, n in inner if ss <= mid < ee]
                name = max(around)[1] if around else OUTSIDE
                total[name] = total.get(name, 0) + (s - cursor)
            cursor = max(cursor, e)
        return [[k, v / 1e9] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def _union(device: list, lo: int, hi: int) -> list:
    """Merged (start, end) intervals of the device operations, clipped to
    [lo, hi)."""
    ivs = sorted((max(s, lo), min(e, hi)) for _, _, s, e in device
                 if e > lo and s < hi)
    merged: list = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:80]


def collect(prof, span_names) -> Trace:
    """The harness's spans and the card's operations from a finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    spans, device = [], []
    for ev in prof.profiler.kineto_results.events():
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            kind = ev.activity_type() if hasattr(ev, "activity_type") else (
                "kernel" if ev.name() not in span_names else "annotation")
            if kind in DEVICE_KINDS:
                device.append((ev.name(), kind, start, end))
        elif ev.name() in span_names:
            spans.append((ev.name(), start, end))
    return Trace(spans, device)
