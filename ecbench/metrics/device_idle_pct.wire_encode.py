"""The card's idle share of the profiled part of the window, in %."""


def read(run):
    return run.idle_pct()
