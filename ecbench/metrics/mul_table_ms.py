"""Device time of the sharded codec's table multiplies a call: the union
of the device operations launched inside the program's spans
``fecc.dist.mul_table`` (``parallel.ntt_dist._mul_table``'s torch ops;
found by correlation id), mean over the profiled calls, in ms, on rank
0's card. None without the program's spans or their launch records."""

from ecbench import spans


def read(run):
    trace = spans.of(run)
    return None if trace is None else trace.busy_ms(
        trace.launched_in("fecc.dist.mul_table"))
