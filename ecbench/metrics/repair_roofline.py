"""The decode's share of its roofline on the card, in %: the least time a
call takes, by the larger of its bytes bound (the surviving blocks read,
the lost ones written) and its operations bound (the decode's modular
multiplies; ``ecbench/ops``), over a profiled call's device-busy time."""


def read(run):
    return run.roofline_pct()
