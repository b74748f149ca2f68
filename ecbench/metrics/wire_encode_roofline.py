"""The GF16 wire encode's share of its roofline on the card, in %: the
least time a call takes, by the larger of its bytes bound (k raw blocks
read, n - k wire parity blocks written) and its operations bound (the
encode's modular multiplies; ``ecbench/ops``), over a profiled call's
device-busy time."""


def read(run):
    return run.roofline_pct()
