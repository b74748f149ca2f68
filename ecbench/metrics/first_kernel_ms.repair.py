"""Host work the card waits for at the start of each call: from the start
of the program's span ``fecc.decode.decode_prepared`` to the launch of the
call's first device operation (its launch record, found by correlation
id), mean over the profiled calls, in ms, on the host's clock alone. It
includes the on-cost of the two spans opened before the first launch (the
entry's and the first pass's), and leaves out the launch call itself and
the card's start-up latency. None without the program's spans."""

from ecbench import spans


def read(run):
    trace = spans.of(run)
    return None if trace is None else trace.first_launch_ms(
        "fecc.decode.decode_prepared")
