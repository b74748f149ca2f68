"""The program's own spans in a traced run, and the device operations
each one launched.

While a profiler records, the port opens spans named ``fecc.*``
(``fastecc_tpu_torch.utils.profiling.scope``): one around each entry's
body (``fecc.rs.encode_parity``, ``fecc.rs.encode_blocks``,
``fecc.decode.decode_prepared``), one around each pass's host work
(``fecc.pass.<key>``, the key of ``ntt_mfa.LAUNCHES``) and one around
the GF16 wire join (``fecc.rs.wire_join``). The harness's
:class:`~ecbench.trace.Trace` keeps its own spans and the card's
operations only. :func:`of` reduces the same finished profiler session
once more and keeps, besides, the program's spans, the host's launch
records (the host's CUDA calls that enqueue a kernel, a fill or a copy:
``LAUNCH_CALLS``) and each device operation's correlation id, which
names the launch record that enqueued it. The innermost program span
around that record is the span that launched the operation. Times are
nanoseconds on the trace's clock, the harness's own. The readers here
never subtract a card's time from a host's: within one process the
card's timestamps can sit milliseconds off the host's.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys

from .trace import DEVICE_KINDS, Trace, _union, short_name

PROGRAM = "fecc."
# Host calls that enqueue work on the card, by the start of their names.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemsetAsync",
                "cudaMemcpyAsync")


@dataclasses.dataclass
class SpanTrace(Trace):
    """A :class:`~ecbench.trace.Trace` whose ``spans`` also hold the
    program's ``fecc.`` spans."""
    launches: dict = dataclasses.field(default_factory=dict)
    # correlation id -> host start of the launch record
    correlation: list = dataclasses.field(default_factory=list)
    # the correlation id of each operation of ``device``, in its order

    def __post_init__(self):
        # the program's spans, and (host start of the launch record, index
        # into device) of each device operation that has one, by start
        self._program = sorted((s, e, n) for n, s, e in self.spans
                               if n.startswith(PROGRAM))
        self._program_starts = [s for s, _, _ in self._program]
        self._launched = sorted((self.launches[c], i)
                                for i, c in enumerate(self.correlation)
                                if c in self.launches)
        self._launch_times = [t for t, _ in self._launched]

    def program(self, lo: int, hi: int, prefix: str = PROGRAM) -> list:
        """(name, start, end) of the program's spans named ``prefix...``
        that start in [lo, hi), the earliest first."""
        found = self._program[bisect.bisect_left(self._program_starts, lo):
                              bisect.bisect_left(self._program_starts, hi)]
        return [(n, s, e) for s, e, n in found if n.startswith(prefix)]

    def launched_between(self, lo: int, hi: int) -> list:
        """(host start of the launch record, index into ``device``) of the
        operations launched in [lo, hi), the earliest first."""
        return self._launched[bisect.bisect_left(self._launch_times, lo):
                              bisect.bisect_left(self._launch_times, hi)]

    def first_launch_ms(self, prefix: str):
        """Mean over the profiled calls of the host time from the start of
        the outermost program span named ``prefix...`` to the launch of the
        call's first device operation, in ms; None where no call holds such
        a span with a launch after it. The host's clock alone: the card's
        timestamps can sit milliseconds off it in a process."""
        waits = []
        for lo, hi in self.calls():
            entry = self.program(lo, hi, prefix)
            ops = entry and self.launched_between(entry[0][1], hi)
            if ops:
                waits.append(ops[0][0] - entry[0][1])
        return sum(waits) / len(waits) / 1e6 if waits else None

    @staticmethod
    def launcher(t: int, spans: list):
        """The name of the innermost of ``spans`` ((name, start, end)) around
        host time ``t``, or None."""
        around = [(s, n) for n, s, e in spans if s <= t < e]
        return max(around)[1] if around else None

    def launched_in(self, name: str) -> list:
        """Per profiled call that holds a span ``name``: the indices of
        the device operations that span launched (the innermost program
        span around their launch records)."""
        out = []
        for lo, hi in self.calls():
            spans = self.program(lo, hi)
            if any(n == name for n, _, _ in spans):
                out.append([i for t, i in self.launched_between(lo, hi)
                            if self.launcher(t, spans) == name])
        return out

    def busy_ms(self, per_call: list):
        """Mean over the calls of the card's busy time (the union) over
        the given device operations of each, in ms; None where none was
        given."""
        if not any(per_call):
            return None
        busy = [sum(e - s for s, e in _union([self.device[i] for i in ops],
                                             0, 1 << 63))
                for ops in per_call]
        return sum(busy) / len(busy) / 1e6

    def unlaunched(self) -> dict:
        """{short name: count} of the device operations that start inside
        a profiled call and have no launch record in the trace."""
        calls = self.calls()
        starts = [lo for lo, _ in calls]
        out: dict = {}
        for i, (name, _, start, _) in enumerate(self.device):
            j = bisect.bisect_right(starts, start) - 1
            corr = self.correlation[i] if i < len(self.correlation) else None
            if j >= 0 and start < calls[j][1] and corr not in self.launches:
                out[short_name(name)] = out.get(short_name(name), 0) + 1
        return out


def collect(prof, span_names) -> SpanTrace:
    """:func:`ecbench.trace.collect`'s reduction of a finished
    ``torch.profiler.profile``, keeping also the program's spans, the
    launch records and the device operations' correlation ids."""
    from torch.autograd import DeviceType
    spans, device, correlation, launches = [], [], [], {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            kind = ev.activity_type() if hasattr(ev, "activity_type") else (
                "annotation" if name in span_names
                or name.startswith(PROGRAM) else "kernel")
            if kind in DEVICE_KINDS:
                device.append((name, kind, start, end))
                correlation.append(ev.correlation_id())
        elif name in span_names or name.startswith(PROGRAM):
            spans.append((name, start, end))
        elif name.startswith(LAUNCH_CALLS):
            launches[ev.correlation_id()] = start
    return SpanTrace(spans, device, launches, correlation)


def _session(trace: Trace):
    """The finished profiler session ``trace`` was reduced from, reduced
    again by :func:`collect`: a ``torch.profiler.profile`` held by a frame
    of the harness's run on the stack, whose window is ``trace``'s."""
    from torch.profiler import profile
    names = {n for n, _, _ in trace.spans}
    frame = sys._getframe(1)
    while frame is not None:
        for value in list(frame.f_locals.values()):
            if (isinstance(value, profile) and getattr(
                    value.profiler, "kineto_results", None) is not None):
                found = collect(value, names)
                if found.window() == trace.window():
                    return found
        frame = frame.f_back
    return None


# id(harness trace) -> (that trace, its SpanTrace or None): one reduction
# a run, however many readers ask
_REDUCED: dict = {}


def of(run):
    """The run's trace with the program's spans: ``run.trace`` itself
    where it is a :class:`SpanTrace`, else the harness's session reduced
    again (:func:`_session`); None outside a traced run or without the
    session. The first reduction of a run says on standard error how many
    program spans its profiled calls hold and which device operations in
    them have no launch record."""
    trace = run.trace
    if trace is None or isinstance(trace, SpanTrace):
        return trace
    if id(trace) not in _REDUCED:
        found = _session(trace)
        _REDUCED[id(trace)] = (trace, found)
        if found is not None:
            calls = found.calls()
            held = sum(len(found.program(lo, hi)) for lo, hi in calls)
            missing = found.unlaunched()
            print(f"program spans: {held} in {len(calls)} profiled calls; "
                  f"device ops without a launch record: "
                  f"{sum(missing.values())} {missing}",
                  file=sys.stderr, flush=True)
    return _REDUCED[id(trace)][1]

