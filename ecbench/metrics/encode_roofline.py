"""The encode's share of its roofline on the card, in %: the least time a
call takes, by the larger of its bytes bound (k data blocks read, n - k
parity blocks written, over the HBM's rate) and its operations bound
(the encode's modular multiplies as products over the integer multiply
rate; ``ecbench/ops``), over a profiled call's device-busy time."""


def read(run):
    return run.roofline_pct()
