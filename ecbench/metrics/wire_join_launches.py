"""Device operations launched inside the program's span
``fecc.rs.wire_join`` (found by correlation id) a call, mean over the
profiled calls. None without the program's spans or their launch
records."""

from ecbench import spans


def read(run):
    trace = spans.of(run)
    if trace is None:
        return None
    per_call = trace.launched_in("fecc.rs.wire_join")
    if not any(per_call):
        return None
    return sum(map(len, per_call)) / len(per_call)
