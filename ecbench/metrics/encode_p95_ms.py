"""95th percentile of every call's fenced time in the window, in ms."""


def read(run):
    return run.call_quantile_ms(0.95)
