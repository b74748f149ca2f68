"""The pack's share of its roofline on the card, in %: the bytes the pack
must move (the operation's ``pack_bytes``: the raw blocks read once, the
field lanes written once) over the HBM's rate, over the pack's device
time a call (``pack_ms``). None where the span launched nothing."""

from ecbench import bench, peaks


def read(run):
    ms = bench.reader("pack_ms")(run)
    if not ms:
        return None
    least_s = run.op.pack_bytes() / peaks.HBM_BYTES_PER_S
    return 100.0 * least_s / (ms / 1e3)
