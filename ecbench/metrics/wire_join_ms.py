"""Device time of the GF16 wire join a call: the union of the device
operations launched inside the program's span ``fecc.rs.wire_join``
(found by correlation id), mean over the profiled calls, in ms. None
without the program's spans or their launch records."""

from ecbench import spans


def read(run):
    trace = spans.of(run)
    return None if trace is None else trace.busy_ms(
        trace.launched_in("fecc.rs.wire_join"))
